"""PyTorch/CUDA port of ``induction_network_on_fewrel_tpu`` (H100, sm_90a).

A package of its own beside the JAX one, mirroring its module paths
(``config``, ``data/``, ``ops/``, ``models/``, ``serving/``). It imports
torch and numpy only — nothing of JAX and nothing of the JAX package, of
which it keeps its own copies where it needs them. This slice ports the
serving path: tokenizer, embedding, the BiLSTM + self-attention encoder on
two hand-written CUDA kernels (``csrc/``), induction routing, the NTN
scorer with its NOTA head, and the synchronous serving core.

Kernels are compiled with ``nvcc`` at their first use on a CUDA tensor
(``kernels/build.py``); importing the package needs neither ``nvcc`` nor a
GPU. Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
