"""Multi-device FLASH decode over a ``(data, seq, state)`` mesh on
``torch.distributed``.

Counterpart of ``flash_viterbi_tpu/parallel/sharded.py``.  JAX runs one
``shard_map`` program; here every rank of the process group runs the body
of JAX's ``local_fn`` on its own shard, and three helpers stand in for the
XLA collectives:

* ``all_gather`` over ``state``, tiled on the last axis in mesh-coordinate
  order, rebuilds a K-vector from the ranks' column shards;
* ``ppermute`` over ``seq``, on the ring i -> i+1 mod n, hands the delta
  carry to the next time block (paired ``isend``/``irecv``;
  ``batch_isend_irecv`` under NCCL);
* ``psum`` over ``seq``, an ``all_reduce`` SUM of the int32 paths, merges
  the blocks' disjoint pieces.

Every rank issues the same collectives in the same order, pipeline bubble
ticks included; otherwise the ring deadlocks.  A collective over an axis
of size 1 is skipped, so a ``(1, 1, 1)`` mesh needs no process group.

The axes (JAX's module docstring has the design):

* ``data``: independent sequences; no traffic until the final gather that
  returns the whole batch to every rank (JAX's ``out_specs=P("data", None)``).
* ``seq``: phase 1 is a software pipeline over equal time blocks
  (microbatches flow GPipe-style, the (mb, K) carry hopping ranks once a
  block); anchors resolve hierarchically through each block's boundary
  plane; phase 2 decodes each block's segments locally.
* ``state``: each rank holds the column shard ``logA[:, lo:lo+Kd]`` and
  computes its slice of every max-plus step with ``maxplus_step_block``
  (the CUDA kernel on a CUDA tensor); carries and pointers are rebuilt with
  the tiled ``all_gather``.

Kernels: every per-step matvec (``local_matvec``, the legacy step) calls
``maxplus_step_block``.  ``use_kernel`` picks only the form of the phases
at ``n_state == 1``: chunked N-lane scans (``maxplus_scan`` +
``backtrack_batched`` in phase 1, ``maxplus_scan_deltas`` +
``argmax_walk`` in phase 2) or per-step steps; never kernel versus plain
version, which the tensors' device alone decides.  JAX takes phase 2's
stored-pointer form where its walk kernel's VMEM bound refuses the shape;
the port's walk takes every shape, so phase 2 always recomputes.

``_CHUNK`` and ``_GROUP_BYTES`` are the JAX package's TPU memory figures,
kept as they are: they bound transient memory and do not change results.

Paths are bit-identical to JAX's ``flash_decode_sharded`` and so to
``flash`` pointer mode (the same strict-'>' lowest-index argmax contract).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..algorithms.flash import flash_midpoints, prop_schedule, segment_layout
from ..ops.cuda import (argmax_walk, backtrack_batched, maxplus_scan,
                        maxplus_scan_deltas, maxplus_step_block)
from ..ops.maxplus import first_argmax
from . import commtrace

AXES = ("data", "seq", "state")

_CHUNK = 512  # time chunk of the phase-1 scans (bounds live emissions)
_GROUP_BYTES = 1 << 30  # stacked-pointer bound of one phase-1 chunk group


class Mesh:
    """A ``(data, seq, state)`` mesh over the ranks of the world.

    Rank ``(d * n_seq + s) * n_state + t`` sits at coordinates ``(d, s,
    t)``, the layout ``init_device_mesh`` gives.  ``device_mesh`` is the
    ``DeviceMesh`` whose per-axis groups carry the collectives; None on a
    ``(1, 1, 1)`` mesh, which issues none.
    """

    def __init__(self, shape: tuple[int, int, int], device_mesh=None):
        self.shape = dict(zip(AXES, shape))
        self.device_mesh = device_mesh
        coords = (0, 0, 0) if device_mesh is None else device_mesh.get_coordinate()
        self.coords = tuple(int(c) for c in coords)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank_at(self, d: int, s: int, t: int) -> int:
        """Global rank at mesh coordinates (d, s, t)."""
        return int(self.device_mesh.mesh[d, s, t])


def make_mesh(n_data: int = 1, n_seq: int = 1, n_state: int = 1,
              backend: str | None = None) -> Mesh:
    """A ``(data, seq, state)`` mesh over the initialised world.

    The world (``parallel.multihost.initialize``) must hold exactly
    ``n_data * n_seq * n_state`` ranks; ``(1, 1, 1)`` needs no process
    group.  ``backend`` overrides the backend of the per-axis groups; None
    keeps the world's.
    """
    shape = (int(n_data), int(n_seq), int(n_state))
    need = shape[0] * shape[1] * shape[2]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        hint = "" if dist.is_initialized() else " (parallel.multihost.initialize first)"
        raise ValueError(f"mesh {shape} needs {need} ranks, the world has {world}{hint}")
    if need == 1:
        return Mesh(shape)
    from torch.distributed.device_mesh import init_device_mesh

    kw = {} if backend is None else {"backend_override": {a: backend for a in AXES}}
    device_type = "cuda" if (backend or dist.get_backend()) == "nccl" else "cpu"
    return Mesh(shape, init_device_mesh(device_type, shape, mesh_dim_names=AXES, **kw))


def mesh_shape_for(n_devices: int) -> tuple[int, int, int]:
    """Factor a device count into a (data, seq, state) mesh shape.

    Prime factors are dealt round-robin to (state, seq, data) so every axis
    is exercised when the count allows (8 -> 2x2x2, 4 -> 1x2x2, 2 -> 1x1x2).
    """
    dims = [1, 1, 1]  # data, seq, state
    n = n_devices
    order = [2, 1, 0]  # state first, then seq, then data
    i = 0
    f = 2
    while n > 1:
        while n % f:
            f += 1
        dims[order[i % 3]] *= f
        n //= f
        i += 1
    return tuple(dims)


# ===========================================================================
# Collectives
# ===========================================================================

def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _operands(mesh: Mesh, axis: str, xs) -> list[torch.Tensor]:
    """``xs`` as the backend of ``axis``'s group takes them.  gloo has no
    CUDA path for every collective, so under gloo every CUDA operand goes
    through pinned host memory, all of ``xs`` copied out before one wait
    for the card (the kernels still run on the card)."""
    xs = [x.contiguous() for x in xs]
    if not xs[0].is_cuda or dist.get_backend(mesh.group(axis)) != "gloo":
        return xs
    host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in xs]
    for h, x in zip(host, xs):
        h.copy_(x, non_blocking=True)
    torch.cuda.current_stream(xs[0].device).synchronize()
    return host


def _upload(t: torch.Tensor, device) -> torch.Tensor:
    """A collective's result on ``device``; a pinned host buffer goes up
    without waiting for the card."""
    return t.to(device, non_blocking=t.is_pinned())


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=t.device, pin_memory=t.is_pinned())


def _all_gather(mesh: Mesh, axis: str, *xs: torch.Tensor, kind: str = "all_gather",
                dim: int = -1):
    """All_gather of each of ``xs`` over ``axis``, tiled on ``dim`` in
    mesh-coordinate order (JAX's ``all_gather(tiled=True)``); one
    collective per operand.  Returns one tensor, or a tuple for several."""
    n = mesh.shape[axis]
    if n == 1:
        return xs[0] if len(xs) == 1 else xs
    out = []
    for x, src in zip(xs, _operands(mesh, axis, xs)):
        commtrace.record(kind, _nbytes(x), n)
        parts = [_empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=mesh.group(axis))
        out.append(torch.cat([_upload(p, x.device) for p in parts], dim=dim))
    return out[0] if len(out) == 1 else tuple(out)


def _ppermute(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Send ``x`` to the next rank on the ``seq`` ring, receive the
    previous rank's."""
    n = mesh.shape["seq"]
    if n == 1:
        return x
    commtrace.record("ppermute", _nbytes(x), n)
    d, s, t = mesh.coords
    nxt, prv = mesh.rank_at(d, (s + 1) % n, t), mesh.rank_at(d, (s - 1) % n, t)
    send = _operands(mesh, "seq", [x])[0]
    recv = _empty_like(send)
    if dist.get_backend(mesh.group("seq")) == "nccl":
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt),
                                       dist.P2POp(dist.irecv, recv, prv)])
    else:
        reqs = [dist.isend(send, nxt), dist.irecv(recv, prv)]
    for req in reqs:
        req.wait()
    return _upload(recv, x.device)


def _psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum of every ``seq`` rank's ``x``."""
    n = mesh.shape["seq"]
    if n == 1:
        return x
    commtrace.record("psum", _nbytes(x), n)
    buf = _operands(mesh, "seq", [x])[0]
    buf = buf.clone() if buf.data_ptr() == x.data_ptr() else buf
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group("seq"))
    return _upload(buf, x.device)


# ===========================================================================
# Pipelined path: equal time blocks, GPipe-style microbatch flow
# ===========================================================================

def _pipeline_plan(T: int, n_seq: int, num_segments: int | None):
    """(L, spd, Lseg) for the pipelined path, or None if the shape doesn't
    divide evenly (the legacy path handles those)."""
    if T % n_seq:
        return None
    L = T // n_seq
    if num_segments is None:
        for spd in (4, 2, 1):
            if L % spd == 0 and L // spd >= 2:
                return L, spd, L // spd
        return None
    N = int(num_segments)
    if N % n_seq:
        return None
    spd = N // n_seq
    if spd < 1 or L % spd or L // spd < 2:
        return None
    return L, spd, L // spd


def _emits(logBT_l: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """(n, N, Kd) emission rows, contiguous, for (N, n) symbols."""
    return logBT_l[sym.t()].contiguous()


def _walk_parts(walk, parts: list[torch.Tensor], state: torch.Tensor) -> torch.Tensor:
    """Walk the chunks ``parts`` back to front from ``state``, chaining
    each chunk's first state into the next walk; (N, 1 + rows) paths."""
    pieces = []
    for part in reversed(parts):
        walked = walk(part, state)
        pieces.append(walked[:, 1:])
        state = walked[:, 0]
    return torch.cat([state[:, None]] + pieces[::-1], dim=1)


def _phase2_segments_kernel(logA_l, logAT_l, logBT_l, logPi, sym_all, entries,
                            exits, first, Lseg: int):
    """Forced-boundary decode of NL equal segments on the scan kernels.

    ``sym_all`` (NL, Lseg) symbols; ``entries``/``exits`` (NL,) boundary
    states (the entry ignored where ``first``, which starts from the
    prior).  Chunked pointer-free scans keep the carry history; the walk
    re-derives each step's argmax from ``logAT_l`` part by part.  Returns
    (NL, Lseg) int32 paths.
    """
    NL = sym_all.shape[0]
    K = logA_l.shape[0]
    d = (torch.where(first[:, None], logPi[None, :].expand(NL, K), logA_l[entries])
         + logBT_l[sym_all[:, 0]])
    # keep the gathered emissions transient <= 64 MB
    Cp2 = min(_CHUNK, max(8, (64 * 1024 * 1024) // (NL * K * 4)))
    parts = []
    for c0 in range(1, Lseg, Cp2):
        d, deltas = maxplus_scan_deltas(logA_l, _emits(logBT_l, sym_all[:, c0:c0 + Cp2]), d)
        parts.append(deltas)
    return _walk_parts(lambda dl, st: argmax_walk(dl, logAT_l, st), parts, exits)


def _flash_decode_pipelined(mesh: Mesh, logA_l, logBT_l, logPi, ys_l, L: int,
                            spd: int, Lseg: int, mb: int, use_kernel: bool):
    """This rank's (Bd, T) paths, summed over ``seq``."""
    n_seq, n_state = mesh.shape["seq"], mesh.shape["state"]
    r = mesh.coords[1]
    Bd, T = ys_l.shape
    K = logPi.shape[0]
    dev = logA_l.device
    if Bd % mb:
        raise ValueError(f"microbatch {mb} must divide the per-data-shard batch {Bd}")
    n_mb = Bd // mb
    ticks = n_mb + n_seq - 1
    chunked = use_kernel and n_state == 1

    # plane record schedule for block steps i = 1..L-1 (ptr row i-1): plane
    # 0 (the block-entry boundary) is recorded at the boundary step and only
    # propagates here; plane m (interior boundary m) is recorded at
    # i == m*Lseg (FLASH_Viterbi_multithread.c:163,176-179)
    rec_np = np.zeros((L - 1, spd), dtype=bool)
    for m_ in range(1, spd):
        rec_np[m_ * Lseg - 1, m_] = True
    rec_sched = torch.as_tensor(rec_np, device=dev)

    def ag(*xs):
        return _all_gather(mesh, "state", *xs)

    def local_matvec(delta):
        """(NL, K) carry -> local (NL, Kd) scores + global argmax."""
        return maxplus_step_block(delta.contiguous(), logA_l)

    def step_local(delta, sym):
        """Full trellis step: (delta' (NL, K), ptr (NL, K))."""
        val_l, ptr_l = local_matvec(delta)
        return ag(val_l + logBT_l[sym], ptr_l)

    def fold_one(planes, ptr, rec):
        """Plane recurrence for one ptr row; rec (nP,) bool selects
        record-vs-propagate per plane."""
        moved = torch.gather(planes, 2, ptr.long()[:, None, :].expand(planes.shape))
        return torch.where(rec[None, :, None], ptr[:, None, :], moved)

    def scan_chunk(d, ys_blk, c0, n):
        return maxplus_scan(logA_l, _emits(logBT_l, ys_blk[:, c0:c0 + n]), d)

    # ---- phase 1: pipelined block forward passes --------------------------
    def block_pass(carry_delta, ys_blk):
        emit0_l = logBT_l[ys_blk[:, 0]]  # (mb, Kd)
        bval_l, bptr_l = local_matvec(carry_delta)  # boundary step
        bval, emit0, bptr = ag(bval_l, emit0_l, bptr_l)  # r == 0 gathers too
        d = (logPi[None, :].expand(mb, K) if r == 0 else bval) + emit0
        planes = torch.cat([bptr[:, None, :],
                            torch.zeros((mb, spd - 1, K), dtype=torch.int32, device=dev)],
                           dim=1)
        if not chunked:
            for i in range(1, L):
                d, ptr = step_local(d, ys_blk[:, i])
                planes = fold_one(planes, ptr, rec_sched[i - 1])
            return d, planes

        n_full = (L - 1) // _CHUNK
        g_c = max(1, _GROUP_BYTES // (_CHUNK * mb * K * 4))
        rem = (L - 1) - n_full * _CHUNK
        groups = [(1 + _CHUNK * g0, min(g_c, n_full - g0) * _CHUNK)
                  for g0 in range(0, n_full, g_c)]
        groups += [(1 + n_full * _CHUNK, rem)] if rem else []
        if n_seq == 1:
            # fold-free phase 1: with one block there is no cross-block
            # chain, the block-entry plane is never read, and the interior
            # anchors are the backtracked path at the segment boundaries
            # (the same pointer rows drive fold and walk, so the values are
            # bit-identical; JAX's sharded.py:283-327)
            parts = []
            for c0, n in groups:
                chunk_ptrs = []
                for cc in range(c0, c0 + n, _CHUNK):
                    d, ptrs = scan_chunk(d, ys_blk, cc, min(_CHUNK, c0 + n - cc))
                    chunk_ptrs.append(ptrs)
                parts.append(torch.cat(chunk_ptrs) if len(chunk_ptrs) > 1 else chunk_ptrs[0])
            path = _walk_parts(backtrack_batched, parts, first_argmax(d, 1)[1])  # (mb, L)
            anchors = path[:, Lseg - 1:(spd - 1) * Lseg:Lseg]  # (mb, spd-1)
            planes = torch.cat([torch.zeros((mb, 1, K), dtype=torch.int32, device=dev),
                                anchors[:, :, None].expand(mb, spd - 1, K)], dim=1)
            return d, planes
        for c0, n in groups:
            for cc in range(c0, c0 + n, _CHUNK):
                d, ptrs = scan_chunk(d, ys_blk, cc, min(_CHUNK, c0 + n - cc))
                for row in range(ptrs.shape[0]):
                    planes = fold_one(planes, ptrs[row], rec_sched[cc - 1 + row])
        return d, planes

    carry = torch.zeros((mb, K), dtype=torch.float32, device=dev)
    planes_t, finals_t = [], []
    for c in range(ticks):
        m_idx = min(max(c - r, 0), n_mb - 1)
        ys_blk = ys_l[m_idx * mb:(m_idx + 1) * mb, r * L:(r + 1) * L]
        d, planes = block_pass(carry, ys_blk)
        carry = _ppermute(mesh, d)
        planes_t.append(planes)
        finals_t.append(d)

    # microbatch m was processed here at tick m + r; it finished at the last
    # block at tick m + n_seq - 1
    my_planes = torch.stack(planes_t[r:r + n_mb])  # (n_mb, mb, spd, K)
    my_finals = torch.stack(finals_t[n_seq - 1:])  # (n_mb, mb, K)

    # ---- anchor resolution: backward chain over blocks --------------------
    # argmax locally before gathering: only the last block's final argmax is
    # read, so ship (n_mb, mb) int32 instead of (n_mb, mb, K) scores
    j_local = first_argmax(my_finals, 2)[1]
    beta_all, j_all = _all_gather(mesh, "seq", my_planes[None, :, :, 0, :], j_local[None],
                                  dim=0)  # (n_seq, n_mb, mb, K), (n_seq, n_mb, mb)
    ends = [None] * n_seq
    ends[n_seq - 1] = j_all[n_seq - 1]
    for rr in range(n_seq - 1, 0, -1):
        ends[rr - 1] = torch.gather(beta_all[rr], 2, ends[rr].long()[..., None])[..., 0]
    jr = ends[r]  # my block-end states (n_mb, mb)
    jprev = torch.zeros_like(jr) if r == 0 else ends[r - 1]

    # ---- phase 2: forced-boundary decode of my segments -------------------
    NL = mb * spd
    first = (r == 0) & (torch.arange(NL, device=dev) % spd == 0)
    logAT_l = logA_l.t().contiguous() if chunked else None
    out = torch.zeros((Bd, T), dtype=torch.int32, device=dev)
    for m in range(n_mb):
        planes_m, jr_m, jp_m = my_planes[m], jr[m], jprev[m]
        # interior anchors: plane m evaluated at the block-end state
        inter = torch.gather(planes_m[:, 1:, :], 2,
                             jr_m.long()[:, None, None].expand(mb, spd - 1, 1))[..., 0]
        entries = torch.cat([jp_m[:, None], inter], dim=1).reshape(NL).long()
        exits = torch.cat([inter, jr_m[:, None]], dim=1).reshape(NL)
        seg_sym = ys_l[m * mb:(m + 1) * mb, r * L:(r + 1) * L].reshape(NL, Lseg)
        if chunked:
            paths = _phase2_segments_kernel(logA_l, logAT_l, logBT_l, logPi, seg_sym,
                                            entries, exits, first, Lseg)
        else:
            entry_rows, emit0 = ag(logA_l[entries], logBT_l[seg_sym[:, 0]])
            d = torch.where(first[:, None], logPi[None, :].expand(NL, K), entry_rows) + emit0
            ptrs = []
            for i in range(1, Lseg):
                d, ptr = step_local(d, seg_sym[:, i])
                ptrs.append(ptr)
            paths = backtrack_batched(torch.stack(ptrs), exits)
        out[m * mb:(m + 1) * mb, r * L:(r + 1) * L] = paths.reshape(mb, L)
    return _psum(mesh, out)


# ===========================================================================
# Legacy path: replicated phase 1, flash_midpoints segment layout (for
# shapes the pipelined path's even-division constraints reject)
# ===========================================================================

def _flash_decode_legacy(mesh: Mesh, logA_l, logBT_l, logPi, ys_l,
                         num_segments: int | None):
    """This rank's (Bd, T) paths: phase 1 replicated over ``seq`` with the
    sequences as lanes, then this rank's ``spd`` segments of each sequence
    as lanes, summed over ``seq``."""
    n_seq = mesh.shape["seq"]
    Bd, T = ys_l.shape
    K, Kd = logA_l.shape
    dev = logA_l.device
    N = num_segments if num_segments is not None else n_seq * max(1, min(4, T // (2 * n_seq)))
    if N % n_seq:
        raise ValueError(f"num_segments={N} must be a multiple of seq axis {n_seq}")
    if T < 2 * N:
        raise ValueError(f"T={T} too short for {N} segments")
    spd = N // n_seq
    mids = flash_midpoints(0, T - 1, N) if N > 1 else []
    starts, lens, Lmax = segment_layout(mids, T)
    lo = mesh.coords[2] * Kd
    logPi_l = logPi[lo:lo + Kd]
    emits_l = logBT_l[ys_l]  # (Bd, T, Kd)

    def ag(*xs):
        return _all_gather(mesh, "state", *xs)

    def step(delta, emit_l):
        """One state-sharded trellis step for every lane: (delta', ptr)."""
        val_l, ptr_l = maxplus_step_block(delta.contiguous(), logA_l)
        return ag(val_l + emit_l, ptr_l)

    # ---- phase 1: multi-anchor forward pass, one lane per sequence --------
    nP = len(mids)
    delta = ag(logPi_l[None, :] + emits_l[:, 0])
    planes = torch.zeros((Bd, nP, K), dtype=torch.int32, device=dev)
    prop = torch.as_tensor(prop_schedule(mids, T), device=dev)  # (T-1, nP)
    for j in range(1, T):
        delta, arg = step(delta, emits_l[:, j])
        if nP:
            moved = torch.gather(planes, 2, arg.long()[:, None, :].expand(Bd, nP, K))
            planes = torch.where(prop[j - 1][None, :, None], moved, arg[:, None, :])
    last = first_argmax(delta, 1)[1]  # (Bd,)
    anchors = torch.gather(planes, 2, last.long()[:, None, None].expand(Bd, nP, 1))[..., 0]
    init_states = torch.cat([torch.zeros((Bd, 1), dtype=torch.int32, device=dev), anchors], 1)
    end_states = torch.cat([anchors, last[:, None]], 1)

    # ---- phase 2: this rank's segments of every sequence, as lanes --------
    s0 = mesh.coords[1] * spd
    seqs = torch.arange(Bd, device=dev).repeat_interleave(spd)  # lane -> sequence
    segs = torch.arange(s0, s0 + spd, device=dev).repeat(Bd)  # lane -> segment
    seg_start = torch.as_tensor(starts, device=dev)[segs]
    seg_steps = torch.as_tensor(lens, device=dev)[segs] - 1
    idx = torch.clamp(seg_start[:, None] + torch.arange(Lmax, device=dev)[None, :], max=T - 1)
    seg_emits_l = emits_l[seqs[:, None], idx]  # (NL, Lmax, Kd)
    init_l = init_states[seqs, segs].long()
    NL = seqs.shape[0]
    d = ag(torch.where((segs == 0)[:, None], logPi_l[None, :].expand(NL, Kd),
                       logA_l[init_l]) + seg_emits_l[:, 0])
    iota = torch.arange(K, dtype=torch.int32, device=dev)
    ptrs = []
    for j in range(1, Lmax):
        dn, p = step(d, seg_emits_l[:, j])
        valid = (j <= seg_steps)[:, None]
        d = torch.where(valid, dn, d)
        ptrs.append(torch.where(valid, p, iota[None, :]))
    paths = backtrack_batched(torch.stack(ptrs), end_states[seqs, segs])  # (NL, Lmax)

    out = torch.zeros((Bd, T), dtype=torch.int32, device=dev)
    for lane in range(NL):
        b, s = divmod(lane, spd)
        st, ln = starts[s0 + s], lens[s0 + s]
        out[b, st:st + ln] = paths[lane, :ln]
    return _psum(mesh, out)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def _local_tables(mesh: Mesh, logA, logB, K: int):
    """This rank's (K, Kd) column shard of logA and (M, Kd) shard of logB.T,
    from the full tables or from the rank's own shards."""
    Kd = K // mesh.shape["state"]
    lo = mesh.coords[2] * Kd
    if tuple(logA.shape) == (K, Kd):
        logA_l = logA.contiguous()
    elif tuple(logA.shape) == (K, K):
        logA_l = logA[:, lo:lo + Kd].contiguous()
    else:
        raise ValueError(f"logA must be (K, K) or its (K, K/n_state) column shard "
                         f"({K}, {Kd}), got {tuple(logA.shape)}")
    if logB.dim() == 2 and logB.shape[0] == Kd:
        logB_l = logB
    elif logB.dim() == 2 and logB.shape[0] == K:
        logB_l = logB[lo:lo + Kd]
    else:
        raise ValueError(f"logB must be (K, M) or its (K/n_state, M) row shard, "
                         f"got {tuple(logB.shape)}")
    return logA_l, logB_l.t().contiguous()


def flash_decode_sharded(mesh: Mesh, logA, logB, logPi, ys,
                         num_segments: int | None = None,
                         microbatch: int = 1,
                         pipeline: bool | str = "auto",
                         use_kernel: bool | str = "auto") -> torch.Tensor:
    """Batched multi-device FLASH decode; every rank of ``mesh`` calls it.

    Args:
      mesh: a (data, seq, state) mesh from :func:`make_mesh`.
      logA/logB/logPi: log tables on this rank's device (padded so the
        'state' axis divides K).  ``logA`` may be the full (K, K) table or
        this rank's (K, K/n_state) column shard, ``logB`` the full (K, M)
        table or its (K/n_state, M) row shard; ``logPi`` is always full.
      ys: (Bs, T) observation batch, the whole batch on every rank ('data'
        divides Bs).
      num_segments: total phase-2 segments; a multiple of the 'seq' axis.
      microbatch: sequences per pipeline microbatch (pipelined path only).
      pipeline: "auto" takes the pipelined path whenever the shape divides
        evenly (T % n_seq == 0, equal segments); False forces the legacy
        path; True raises if the shape does not divide.
      use_kernel: the chunked-scan form of the phases at n_state == 1
        ("auto": on CUDA tensors); the per-step form otherwise.

    Returns:
      (Bs, T) int32 paths on every rank, on the tables' device,
      bit-identical to ``flash`` pointer mode on every mesh shape.
    """
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must come from make_mesh, got {type(mesh).__name__}")
    n_data, n_seq, n_state = (mesh.shape[a] for a in AXES)
    dev = logA.device
    ys = torch.as_tensor(ys).to(device=dev, dtype=torch.int64)
    Bs, T = ys.shape
    K = logPi.shape[0]
    if K % n_state:
        raise ValueError(f"state axis {n_state} must divide padded K={K}")
    if Bs % n_data:
        raise ValueError(f"data axis {n_data} must divide batch {Bs}")
    if T < 2 * n_seq:
        raise ValueError(f"T={T} too short for seq axis {n_seq} "
                         f"(each seq device needs a >=2-step segment)")
    if num_segments is not None:
        # clamp like the single-device decoder (N <= T//2), rounded down to
        # the required multiple of the seq axis
        N = min(int(num_segments), max(1, T // 2))
        num_segments = max(n_seq, (N // n_seq) * n_seq)

    logA_l, logBT_l = _local_tables(mesh, logA, logB, K)
    Bd = Bs // n_data
    ys_l = ys[mesh.coords[0] * Bd:(mesh.coords[0] + 1) * Bd]
    plan = _pipeline_plan(T, n_seq, num_segments)
    if pipeline is True and plan is None:
        raise ValueError(
            f"pipelined path needs T divisible into equal segments per seq "
            f"device (T={T}, n_seq={n_seq}, num_segments={num_segments})")
    if pipeline is False or plan is None:
        out = _flash_decode_legacy(mesh, logA_l, logBT_l, logPi, ys_l, num_segments)
    else:
        if use_kernel == "auto":
            use_kernel = dev.type == "cuda"
        out = _flash_decode_pipelined(mesh, logA_l, logBT_l, logPi, ys_l, *plan,
                                      int(microbatch), bool(use_kernel))
    return _all_gather(mesh, "data", out, kind="data_gather", dim=0)
