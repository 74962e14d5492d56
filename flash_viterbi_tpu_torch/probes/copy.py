"""The asynchronous-copy and barrier probes: CUDA kernels and their plain
versions.

Counterparts of ``scripts/beam_dma_probe.py``'s ``p1``, ``p3``, ``p4`` and
``p5``; the kernels are ``csrc/probe_copy.cu``.  p1 and p3 copy rows with
TMA bulk copies that an earlier step started, over the CTAs and ring
stages of :func:`copy_plan` (p3: B copies a step, issued from a loop onto
one barrier); p4 publishes per-thread results through an mbarrier and
reads them back as block-uniform scalars; p5 is the lexicographic winner
of ``csrc/argmax.cuh``'s combine as a warp and block tournament.  Their
plain versions are the identity, ``t + 1`` and the winner in torch.

Every mbarrier wait in the kernels gives up after about a second and sets
an error flag, which the wrapper reads back (one synchronisation a call)
and raises on, so a wrong barrier phase fails the call instead of hanging
the card; p1 and p3 take ``err=``, a word that several calls share and
their caller reads once (:func:`raise_on`).  ``beam_dma_probe.p5`` itself
cannot run: it imports ``_lex_winner``, which
``flash_viterbi_tpu/ops/pallas/beam.py`` no longer has, so p5's plain
version is held against the expression the TPU probe asserts,
``min(zip(-v, c))``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..bench.harness import device_name, marginal_time
from ..models.hmm import resolve_device
from ..ops.cuda.beam import SMEM_LIMIT
from ..ops.cuda.common import expect, expect_contiguous, launch, on_cuda
from ..ops.cuda.maxplus import sm_count

# beam_dma_probe.py's fixture: Tm steps of (S, 128) float32; p3's B; p4's
# W; p5's output width
TM, S = 4, 2
P3_B = 4
P4_W = 8
P5_WIDTH = 128
# the beam scan's shape: T' = 255 steps of a padded K = 3968 row (15872
# bytes, a multiple of 16 as a bulk copy needs)
BEAM_TM, BEAM_K = 255, 3968
ERRORS = {1: "an mbarrier wait timed out", 2: "a bulk-copied buffer differs from the first"}
STAGES_MAX = 16      # ring stages a CTA (csrc: STAGES_MAX)
STATIC_SMEM = 8 * STAGES_MAX  # the kernel's static shared memory: a barrier a stage


class CopyPlan(NamedTuple):
    """How p1 and p3 spread Tm steps: CTA g copies the steps
    ``step_edges[g]`` up to ``step_edges[g + 1]`` through a ring of
    ``stages`` stages of B rows each."""

    ctas: int
    stages: int
    step_edges: tuple

    def c_args(self):
        """The int array fvt_probe_copy_rows takes (csrc: CopyField)."""
        return (ctypes.c_int * 2)(self.ctas, self.stages)


def copy_plan(Tm: int, n: int, B: int, sm_count: int, ctas: int | None = None) -> CopyPlan:
    """The CTAs and ring stages for Tm steps of ``B`` copies of an n-float
    row on ``sm_count`` SMs: one CTA an SM up to one a step (``ctas``
    forces another count), each owning a contiguous run of steps, and as
    many stages as its longest run takes, at least 2, at most what shared
    memory holds beside the barriers (1 where two stages do not fit)."""
    if min(Tm, n, B, sm_count) < 1:
        raise ValueError(f"need Tm, n, B, sm_count >= 1, got {Tm}, {n}, {B}, {sm_count}")
    G = min(Tm, sm_count) if ctas is None else ctas
    if not 1 <= G <= Tm:
        raise ValueError(f"ctas must lie in [1, {Tm}], got {G}")
    if B * n * 4 > SMEM_LIMIT:
        raise ValueError(f"{B} rows of {n * 4} bytes exceed the {SMEM_LIMIT} bytes of "
                         f"shared memory one H100 block can use")
    fit = max(1, (SMEM_LIMIT - STATIC_SMEM) // (B * n * 4))
    stages = min(STAGES_MAX, fit, max(2, -(-Tm // G)))
    return CopyPlan(ctas=G, stages=stages, step_edges=tuple(g * Tm // G for g in range(G + 1)))


# the plan of each shape, made once (a call's host time is part of its time)
_cached_copy_plan = functools.lru_cache(maxsize=64)(copy_plan)


def raise_on(err: torch.Tensor, what: str) -> None:
    """Read the error word ``err`` (a host synchronisation on the card) and
    raise naming every bit set."""
    code = int(err.item())
    if code:
        raise RuntimeError(f"{what}: " + "; ".join(m for bit, m in ERRORS.items() if code & bit))


def _check_rows(x: torch.Tensor, nbuf: int) -> tuple[int, int]:
    """(Tm, n): ``x`` is (Tm, ...) float32, each step's row of n floats a
    whole number of 16-byte units, ``nbuf`` rows fitting a block."""
    if x.dim() < 2:
        raise ValueError(f"x must be (Tm, ...), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    Tm, n = x.shape[0], x[0].numel()
    if Tm < 1 or n < 4 or n % 4:
        raise ValueError(f"a step's row must be a positive multiple of 16 bytes, got {n * 4}")
    if nbuf * n * 4 > SMEM_LIMIT:
        raise ValueError(f"{nbuf} rows of {n * 4} bytes exceed the {SMEM_LIMIT} bytes of "
                         f"shared memory one H100 block can use")
    return Tm, n


def _copy_rows(counter, x: torch.Tensor, nbuf: int, plan: CopyPlan | None,
               err: torch.Tensor | None) -> torch.Tensor:
    Tm, n = _check_rows(x, nbuf)
    if not on_cuda(x):
        return x.clone()
    expect_contiguous(x=x)
    if x.data_ptr() % 16:
        raise ValueError("x must start at a 16-byte-aligned address for a bulk copy")
    if plan is None:
        plan = _cached_copy_plan(Tm, n, nbuf, sm_count(x.device))
    elif plan.step_edges[-1] != Tm or plan.stages * nbuf * n * 4 > SMEM_LIMIT:
        raise ValueError(f"the plan is for {plan.step_edges[-1]} steps of {plan.stages} stages, "
                         f"not for {Tm} steps of {nbuf} rows of {n * 4} bytes")
    out = torch.empty_like(x)
    word = torch.zeros(1, dtype=torch.int32, device=x.device) if err is None else err
    launch("fvt_probe_copy_rows", counter, x.device, x.data_ptr(), out.data_ptr(),
           plan.c_args(), Tm, n, nbuf, word.data_ptr())
    if err is None:
        raise_on(word, counter.__name__)
    return out


def probe_copy_p1(x: torch.Tensor, *, plan: CopyPlan | None = None,
                  err: torch.Tensor | None = None) -> torch.Tensor:
    """p1: ``x`` (Tm, ...) float32 copied step by step, each step's row
    bulk-copied into shared memory by an earlier step; returns the copy.
    ``plan``: the CTAs and stages (default: :func:`copy_plan` for the
    card); ``err``: an int32 word shared by several calls, which the
    caller reads with :func:`raise_on` (by default the call reads its own)."""
    return _copy_rows(probe_copy_p1, x, 1, plan, err)


def probe_copy_p3(x: torch.Tensor, *, plan: CopyPlan | None = None,
                  err: torch.Tensor | None = None) -> torch.Tensor:
    """p3: as p1 with ``P3_B`` bulk copies of each row a step, issued from
    a loop and completing on one barrier; raises if any buffer differs."""
    return _copy_rows(probe_copy_p3, x, P3_B, plan, err)


def probe_copy_p4_plain(Tm: int = TM, W: int = P4_W, device="cpu") -> torch.Tensor:
    """Plain version of :func:`probe_copy_p4`: out[t, 0, j] = t + 1."""
    t = torch.arange(1, Tm + 1, dtype=torch.int32, device=device)
    return t[:, None, None].expand(Tm, 1, W).contiguous()


def probe_copy_p4(Tm: int = TM, W: int = P4_W, device="cuda") -> torch.Tensor:
    """p4: (Tm, 1, W) int32 where entry (t, 0, j) is thread j's step-t
    result read back through shared memory and an mbarrier, plus one."""
    if Tm < 1 or not 1 <= W <= 32:
        raise ValueError(f"need Tm >= 1 and 1 <= W <= 32, got Tm={Tm}, W={W}")
    out = torch.empty((Tm, 1, W), dtype=torch.int32, device=resolve_device(device))
    if not on_cuda(out):
        return probe_copy_p4_plain(Tm, W, out.device)
    err = torch.zeros(1, dtype=torch.int32, device=out.device)
    launch("fvt_probe_copy_p4", probe_copy_p4, out.device, out.data_ptr(), Tm, W,
           err.data_ptr())
    raise_on(err, "probe_copy_p4")
    return out


def probe_copy_p5_plain(v: torch.Tensor, c: torch.Tensor):
    """Plain version of :func:`probe_copy_p5`: the larger value, then the
    lower code, broadcast to (1, 128)."""
    best = v.max()
    code = torch.where(v == best, c, torch.iinfo(torch.int32).max).min()
    return best.expand(1, P5_WIDTH).contiguous(), code.expand(1, P5_WIDTH).contiguous()


def probe_copy_p5(v: torch.Tensor, c: torch.Tensor):
    """p5: the lexicographic winner of the (value, code) pairs ``v``
    float32 and ``c`` int32 (one shape, no NaN) as (outv (1, 128)
    float32, outc (1, 128) int32), the TPU probe's output."""
    if v.dtype != torch.float32:
        raise TypeError(f"v must be torch.float32, got {v.dtype}")
    expect("c", c, torch.int32, tuple(v.shape))
    if v.numel() < 1:
        raise ValueError("p5 needs at least one pair")
    if not on_cuda(v, c):
        return probe_copy_p5_plain(v, c)
    expect_contiguous(v=v, c=c)
    outv = torch.empty((1, P5_WIDTH), dtype=torch.float32, device=v.device)
    outc = torch.empty((1, P5_WIDTH), dtype=torch.int32, device=v.device)
    launch("fvt_probe_copy_p5", probe_copy_p5, v.device, v.data_ptr(), c.data_ptr(), v.numel(),
           outv.data_ptr(), outc.data_ptr(), P5_WIDTH)
    return outv, outc


probe_copy_p1.launches = 0
probe_copy_p3.launches = 0
probe_copy_p4.launches = 0
probe_copy_p5.launches = 0


def fixture(Tm: int = TM, S_: int = S, device="cuda") -> torch.Tensor:
    """p1's and p3's input: ``arange(Tm * S * 128)`` as (Tm, S, 128) f32."""
    return torch.arange(Tm * S_ * 128, dtype=torch.float32,
                        device=resolve_device(device)).reshape(Tm, S_, 128)


def beam_rows(Tm: int = BEAM_TM, Kp: int = BEAM_K, device="cuda", seed: int = 0) -> torch.Tensor:
    """(Tm, Kp) standard normal float32 from ``seed``: a beam scan's rows."""
    x = np.random.default_rng(seed).standard_normal((Tm, Kp)).astype(np.float32)
    return torch.as_tensor(x, device=resolve_device(device))


def p5_fixture(S_: int = S, device="cuda", seed: int = 0):
    """p5's input: v (S, 128) standard normal from ``seed`` with a forced
    tie for the maximum at [0, 5] and [1, 7]; c = index * 256 + 3."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((S_, 128)).astype(np.float32)
    v[0, 5] = v[1, 7] = v.max() + 1.0
    c = np.arange(S_ * 128, dtype=np.int32).reshape(S_, 128) * 256 + 3
    dev = resolve_device(device)
    return torch.as_tensor(v, device=dev), torch.as_tensor(c, device=dev)


def run(device="cuda", beam_tm: int = BEAM_TM, beam_k: int = BEAM_K) -> list[dict]:
    """Every probe of ``beam_dma_probe.py`` at its fixture, and p1 and p3
    also over a beam scan's rows; chains of 1 and 5 calls, one record each
    with the bytes a call must move (each input read once, each output
    written once).  p1 and p3 share one error word, read once after their
    chains, so no call of a chain waits for the host (as ``Tensor.copy_``
    does not)."""
    dev = resolve_device(device)
    x, rows = fixture(device=dev), beam_rows(beam_tm, beam_k, dev)
    v, c = p5_fixture(device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    shared = {"err": err}
    cases = [("p1", probe_copy_p1, (x,), shared, 2 * x.numel() * 4, 0),
             ("p1_beam_rows", probe_copy_p1, (rows,), shared, 2 * rows.numel() * 4, 0),
             ("p3", probe_copy_p3, (x,), shared, 2 * x.numel() * 4, 0),
             ("p3_beam_rows", probe_copy_p3, (rows,), shared, 2 * rows.numel() * 4, 0),
             ("p4", probe_copy_p4, (TM, P4_W, dev), {}, TM * P4_W * 4, 0),
             ("p5", probe_copy_p5, (v, c), {}, (v.numel() + c.numel() + 2 * P5_WIDTH) * 4,
              2 * v.numel())]
    records = []
    for variant, fn, args, kw, moved, ops in cases:
        per = marginal_time(lambda k, fn=fn, args=args, kw=kw: (
            lambda: [fn(*args, **kw) for _ in range(k)][-1]))
        records.append({"probe": "beam_dma_probe", "variant": variant, "kernel": fn.__name__,
                        "device": device_name(dev), "per_call_s": per, "bytes": moved,
                        "operations": ops})
    raise_on(err, "probe_copy_p1 / probe_copy_p3")
    return records
