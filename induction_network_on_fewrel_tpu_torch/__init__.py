"""PyTorch/CUDA port of ``induction_network_on_fewrel_tpu`` (H100, sm_90a).

A package of its own beside the JAX one, mirroring its module paths
(``config``, ``data/``, ``ops/``, ``models/``, ``sampling/``, ``train/``,
``utils/``, ``serving/``, ``cli``). It imports torch and numpy only —
nothing of JAX and nothing of the JAX package, of which it keeps its own
copies where it needs them. Two slices are ported: the serving path
(tokenizer, embedding, the BiLSTM + self-attention encoder, induction
routing, the NTN scorer with its NOTA head, the synchronous serving core)
and the training path (episode sampler, the optax-equivalent optimizer
chain, train/eval steps, checkpoints, ``FewShotTrainer``, the train/test
CLI). Every Pallas kernel of the JAX package has a hand-written CUDA
counterpart (``csrc/``): K1/K2 forward-only for eval and serving, K7/K8
(windowed BiLSTM forward and backward) or, at ``lstm_cs_window=0``, K4/K6
(the full-residual twin), and K10/K11 (attention forward with stats and
backward) for training; kernels 1-3 run the split recurrence over
pre-projected gates (``ops.lstm.lstm_recurrence*``).

Kernels are compiled with ``nvcc`` at their first use on a CUDA tensor
(``kernels/build.py``); importing the package needs neither ``nvcc`` nor a
GPU. Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
