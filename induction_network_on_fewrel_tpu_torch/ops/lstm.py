"""Fused BiLSTM forward: the plain PyTorch version and the CUDA kernel K1.

``bilstm_encoder_tm`` is the counterpart of
``induction_network_on_fewrel_tpu/ops/lstm.py:bilstm_encoder_tm`` on its
no-grad path, the primal of ``_bilstm_fused_tm``, which runs the Pallas
kernel ``_fused_fwd_kernel_infer``: the input projection and the
bidirectional recurrence in one pass, with the projected gates never
stored. The public signature and layout are the JAX package's:

    emb_t [L, M, D], wih [2, D, 4u], b [2, 1, 4u], whh [2, u, 4u]
      -> hs [L, M, 2u]   (cols [0:u] forward, [u:2u] reverse, natural time)

Dtype placement follows the kernel path exactly (lstm.py:1303-1307): wih
is cast to the embedding dtype, b and whh to f32; gate pre-activations
accumulate in f32; the h and c carries are f32; hs is written in the
embedding dtype. In bf16 this differs from the JAX ``scan`` backend (which
stores the projection and adds the bias in bf16), so the plain version
here is held against JAX ``backend="interpret"`` in bf16 and against both
in f32 (tests/test_torch_ops.py). Gate order is [i, f, g, o].

Backends (``ops.core.resolve_backend``): "reference" is the plain version,
"cuda" the hand-written kernel in ``csrc/bilstm_infer.cu`` (CUDA tensors
only), "auto" picks by the tensor's device. The kernel masks its ragged
last row tile itself, so no padded copy is made (the JAX call pads rows to
its tile, lstm.py:1297-1302).
"""

from __future__ import annotations

import torch

from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY, check_cuda_tensors
from induction_network_on_fewrel_tpu_torch.ops.core import resolve_backend

ACTIVATION_DTYPES = (torch.float32, torch.bfloat16)


def bilstm_encoder_tm(
    emb_t: torch.Tensor,
    wih: torch.Tensor,
    b: torch.Tensor,
    whh: torch.Tensor,
    backend: str = "auto",
) -> torch.Tensor:
    """Projection + bidirectional recurrence over natural-time embeddings."""
    wih = wih.to(emb_t.dtype).contiguous()
    b = b.float().contiguous()
    whh = whh.float().contiguous()
    if resolve_backend(backend, emb_t.device) == "cuda":
        return bilstm_infer_cuda(emb_t.contiguous(), wih, b, whh)
    return bilstm_reference(emb_t, wih, b, whh)


def bilstm_reference(emb_t, wih, b, whh) -> torch.Tensor:
    """The plain PyTorch version of K1, with the kernel's dtype placement:
    bf16 products are exact in f32, so upcasting the operands and
    multiplying in f32 is the f32 accumulation the kernel does."""
    L, M, _ = emb_t.shape
    _, u, G = whh.shape
    x = emb_t.float()
    wih32, b32, whh32 = wih.to(emb_t.dtype).float(), b.float(), whh.float()
    hs = torch.empty((L, M, 2 * u), dtype=emb_t.dtype, device=emb_t.device)
    for d in range(2):
        xg = torch.matmul(x, wih32[d]) + b32[d]            # [L, M, 4u] f32
        h = x.new_zeros((M, u))
        c = x.new_zeros((M, u))
        for t in (range(L) if d == 0 else range(L - 1, -1, -1)):
            a = xg[t] + h @ whh32[d]
            i = torch.sigmoid(a[:, :u])
            f = torch.sigmoid(a[:, u:2 * u])
            g = torch.tanh(a[:, 2 * u:3 * u])
            o = torch.sigmoid(a[:, 3 * u:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            hs[t, :, d * u:(d + 1) * u] = h.to(emb_t.dtype)
    return hs


def bilstm_infer_cuda(emb_t, wih, b, whh) -> torch.Tensor:
    """Launch K1 on the current stream (no synchronize). Raises for CPU
    tensors, unsupported dtypes, shapes or layouts, and launch failures."""
    L, M, D = emb_t.shape
    check_cuda_tensors("bilstm_infer_cuda", emb_t, wih, b, whh)
    if emb_t.dtype not in ACTIVATION_DTYPES or wih.dtype != emb_t.dtype:
        raise TypeError(
            f"bilstm_infer_cuda: emb/wih must share a dtype in "
            f"{ACTIVATION_DTYPES}, got {emb_t.dtype}/{wih.dtype}"
        )
    if b.dtype != torch.float32 or whh.dtype != torch.float32:
        raise TypeError("bilstm_infer_cuda: b and whh must be float32")
    if whh.dim() != 3 or whh.shape[0] != 2 or whh.shape[2] != 4 * whh.shape[1]:
        raise ValueError(f"bilstm_infer_cuda: whh must be [2, u, 4u], got {tuple(whh.shape)}")
    u = whh.shape[1]
    G = 4 * u
    if tuple(wih.shape) != (2, D, G) or tuple(b.shape) != (2, 1, G):
        raise ValueError(
            f"bilstm_infer_cuda: wih {tuple(wih.shape)} / b {tuple(b.shape)} "
            f"do not match D={D}, u={u}"
        )
    if G > 512:
        raise ValueError(f"bilstm_infer_cuda: 4u = {G} exceeds the kernel's 512 threads")
    hs = torch.empty((L, M, 2 * u), dtype=emb_t.dtype, device=emb_t.device)
    if L == 0 or M == 0:
        return hs
    with torch.cuda.device(emb_t.device):
        LIBRARY.launch(
            "bilstm_infer_fwd",
            emb_t.data_ptr(), wih.data_ptr(), b.data_ptr(), whh.data_ptr(),
            hs.data_ptr(), L, M, D, u, int(emb_t.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    bilstm_infer_cuda.launches += 1
    return hs


bilstm_infer_cuda.launches = 0

