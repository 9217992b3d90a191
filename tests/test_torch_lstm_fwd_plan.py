"""The launch plan of the cluster LSTM forward (K1, K7, K4, kernels 1/2).

The kernel itself runs only on the card (``chip_smoke.py``); here the plan
that the wrappers hand to its launchers is checked on the CPU: it fits a
block's shared memory at the flagship widths, the cluster divides u, the
CTAs at M=200 make one wave, its byte formula is the header's, every
forward wrapper passes it, and a width the body cannot take is refused
before anything is launched. The phase profiler of the body
(``kernels/fwd_phases.py``) names every phase mark of the header.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import re

import pytest
import torch

import induction_network_on_fewrel_tpu_torch.ops.lstm as tlstm
from induction_network_on_fewrel_tpu_torch.kernels import fwd_phases
from induction_network_on_fewrel_tpu_torch.kernels.build import CSRC

L, D, U = 40, 60, 128          # the flagship widths
ROWS = (1, 4, 16, 25, 100, 200)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("proj", [True, False], ids=["fused", "split"])
def test_fwd_plan_fits_shared_memory(M, proj):
    plan = tlstm.fwd_plan(M, D if proj else 0, U)
    assert plan.smem <= tlstm.SMEM_LIMIT
    assert plan.cluster == 8 and U % plan.cluster == 0
    assert plan.tm % 4 == 0 and plan.threads == tlstm.FWD_THREADS
    assert plan.ctas == -(-M // plan.tm) * 2 * plan.cluster
    assert plan.ctas <= tlstm.NUM_SMS                 # one wave at every M here


def test_fwd_plan_m200_is_one_wave_of_clusters():
    plan = tlstm.fwd_plan(200, D, U)
    assert (plan.tm, plan.cluster, plan.ctas) == (32, 8, 112)
    # A 16-row tile would take 13 x 2 x 8 = 208 CTAs, more than one wave.
    assert tlstm.fwd_plan(100, D, U).tm == 16
    assert tlstm.fwd_plan(16, D, U).ctas == 16       # a serving bucket on 16 SMs


def test_fwd_smem_formula_matches_the_header():
    """``lstm::fwd_smem`` in csrc/lstm_common.cuh, written out at the
    flagship widths (NC = 4u/8 = 64 columns a CTA; split-K S = 4 at TM=16,
    2 at TM=32; projection split P = 2 at TM=16, 1 at TM=32): two mbarriers,
    W_hh [u, NC], W_ih [D, NC], b [NC], 2 h [u, TM + 4], gates [P, TM, NC],
    partials [S, TM, NC + 8], embeddings [D, TM + 2]."""
    nc = 64
    assert tlstm.fwd_psplits(16, 8, D, U) == 2 and tlstm.fwd_psplits(32, 8, D, U) == 1
    assert tlstm.fwd_smem(16, 8, D, U) == 16 + 4 * (U * nc + D * nc + nc + 2 * U * 20
                                                    + 2 * 16 * nc + 4 * 16 * 72 + D * 18)
    assert tlstm.fwd_smem(32, 8, D, U) == 16 + 4 * (U * nc + D * nc + nc + 2 * U * 36
                                                    + 32 * nc + 2 * 32 * 72 + D * 34)
    assert tlstm.fwd_smem(16, 8, 0, U) == 16 + 4 * (U * nc + 2 * U * 20 + 16 * nc
                                                    + 4 * 16 * 72)
    src = (CSRC / "lstm_common.cuh").read_text()
    assert "constexpr int FWD_THREADS = 256;" in src and tlstm.FWD_THREADS == 256
    assert f"constexpr size_t SMEM_LIMIT = {tlstm.SMEM_LIMIT};" in src


def _fused(dt, M, u=U, d=D):
    return (torch.zeros((L, M, d), dtype=dt), torch.zeros((2, d, 4 * u), dtype=dt),
            torch.zeros((2, 1, 4 * u)), torch.zeros((2, u, 4 * u)))


def _call(wrapper, dt, M, u=U, d=D):
    """Call a forward wrapper on CPU tensors of the given widths."""
    if wrapper == "K1":
        return tlstm.bilstm_infer_cuda(*_fused(dt, M, u, d))
    if wrapper == "K7":
        return tlstm.bilstm_win_fwd(*_fused(dt, M, u, d), 8, dt)
    if wrapper == "K4":
        return tlstm.bilstm_full_fwd(*_fused(dt, M, u, d), dt)
    xg, whh = torch.zeros((L, M, 8 * u), dtype=dt), torch.zeros((2, u, 4 * u))
    if wrapper == "split2":
        return tlstm.lstm_split_infer_cuda(xg, whh, True)
    return tlstm.lstm_split_fwd(xg, whh, True)


WRAPPERS = {"K1": "bilstm_infer_fwd", "K7": "bilstm_win_fwd", "K4": "bilstm_full_fwd",
            "split2": "lstm_split_fwd_infer", "split1": "lstm_split_fwd"}
COUNTED = {"K1": tlstm.bilstm_infer_cuda, "K7": tlstm.bilstm_win_fwd, "K4": tlstm.bilstm_full_fwd,
           "split2": tlstm.lstm_split_infer_cuda, "split1": tlstm.lstm_split_fwd}


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_forward_wrappers_launch_with_the_plan(monkeypatch, wrapper, dt, M):
    """Each forward wrapper (all three residual modes, both dtypes) hands
    its launcher the plan's row tile and cluster size as the last two
    arguments; the launch is recorded instead of run."""
    calls = []
    monkeypatch.setattr(tlstm, "check_cuda_tensors", lambda *a: None)
    monkeypatch.setattr(tlstm, "_launch", lambda name, dev, *args: calls.append((name, args)))
    _call(wrapper, dt, M)
    plan = tlstm.fwd_plan(M, D if wrapper.startswith("K") else 0, U)
    assert [(n, a[-2:]) for n, a in calls] == [(WRAPPERS[wrapper], (plan.tm, plan.cluster))]


# u = 127 leaves a cluster of one CTA with 127 units (more gate tiles than
# threads); D = 1000 puts a 256 KB W_ih slice in shared memory (the split
# kernels have no projection, so D does not bind them).
REFUSED = [(w, 127, D, "threads") for w in sorted(WRAPPERS)]
REFUSED += [(w, U, 1000, "shared memory") for w in ("K1", "K4", "K7")]


@pytest.mark.parametrize("wrapper, u, d, why", REFUSED)
def test_wrapper_refuses_widths_the_body_cannot_take(wrapper, u, d, why):
    """Refused by name before any device check or launch."""
    fn = COUNTED[wrapper]
    before = fn.launches
    with pytest.raises(ValueError, match=f"cannot take .*{why}"):
        _call(wrapper, torch.float32, 16, u, d)
    assert fn.launches == before


def test_phase_profiler_names_every_mark(monkeypatch):
    """kernels/fwd_phases.py names one phase per FWD_PHASE mark of the
    forward body, in the marks' order, and its reader reads all of them;
    without a card it refuses before building anything."""
    src = (CSRC / "lstm_common.cuh").read_text()
    marks = [int(i) for i in re.findall(r"FWD_PHASE\((\d)\);", src)]
    assert marks == list(range(len(fwd_phases.PHASES)))
    assert f"fwd_phase_cycles[{len(marks)}]" in src
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(fwd_phases, "build", lambda: pytest.fail("built without a card"))
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        fwd_phases.main([])
