#!/usr/bin/env python3
"""Time variants of the port's step-block kernel on the GPU, each built from
a copy of the package whose ``csrc/maxplus_scan.cu`` is edited.

    python3 scripts/torch_step_variants.py WORKDIR [VARIANT ...]

It prints the card's name and power limit first.  For each VARIANT (all
of :data:`VARIANTS` by default) the package is copied
into ``WORKDIR/<variant>`` with the variant's edits, and a fresh process
builds that copy, prints ``step_block_kernel``'s ``ptxas`` registers and
spills, holds the kernel against ``maxplus_step_block_plain`` on values in
halves (the cost-attribution variants, which drop part of the work, are
expected to differ and print MISMATCH), and prints for each shape of
:data:`SHAPES` and each range count R of the plan (the default and 1, 2,
4, 8, 16 where Ks >= 3968 and Kd >= 992) the device time a call: back to
back (chains of 20 calls queued behind a sleep of the card, so the host's
launch cost is hidden) and with L2 flushed before each call (the runs
queued the same way).  ``base`` also times p1 and p3 of the copy probe
beside ``Tensor.copy_`` the same two ways.

Variants: ``base`` (the kernel as it is); ``guard`` (each row of an
unrolled group tested against the chunk's end, as first written);
``masked`` (the strict '>' as a compare mask and bit selects, no
predicate); ``lb3u4`` (4 rows in flight, 3 blocks an SM); and, for cost
attribution only, ``nocarry`` (the carry read from shared memory replaced
by a constant), ``noload`` (the logA_blk loads replaced by a value computed
in registers) and ``maxonly`` (the max without its index).
"""

from __future__ import annotations

import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "flash_viterbi_tpu_torch", "csrc", "maxplus_scan.cu")
SHAPES = [(1, 3968, 3968), (16, 3968, 992), (1, 16384, 4096), (1, 3968, 1984),
          (16, 3968, 1984), (8, 3968, 1984), (20, 1000, 250), (16, 15872, 992),
          (4, 3968, 3968), (64, 3968, 992), (1, 32, 32)]

_FOLD = "                    fold<LG, CPT, true>(best, arg, d, cur[u], lr + u);"
_UNROLL = "    constexpr int UNROLL = unroll_rows<LG>();\n    constexpr int TW = 32 * CPT;"
_GROUPS_START = "            // whole groups of UNROLL rows"
_GROUPS_END = "    // the warps' partials meet"
_GUARDED = """            for (int lr = k0; lr < kend; lr += UNROLL) {
                float cur[UNROLL][CPT];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
                    for (int j = 0; j < CPT; ++j) cur[u][j] = nxt[u][j];
                }
                if (lr + UNROLL < s1) {
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u) {
                        load_row<CPT>(nxt[u], logA + (size_t)min(lr + UNROLL + u, s1 - 1) * Kd,
                                      col, Kd, vec);
                    }
                }
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    if (lr + u < kend) {
                        float d[LG];
                        load_carry<LG>(d, s_c + (lr + u - k0) * LG);
                        fold<LG, CPT, true>(best, arg, d, cur[u], lr + u);
                    }
                }
            }
        }
    }

"""
_MASKED_FOLD = """template <int LG, int CPT>
__device__ __forceinline__ void fold_masked(float (&best)[LG][CPT], int (&arg)[LG][CPT],
                                            const float (&d)[LG], const float (&a)[CPT], int k) {
#pragma unroll
    for (int n = 0; n < LG; ++n) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            const float v = d[n] + a[j];
            unsigned m;
            asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(m) : "f"(v), "f"(best[n][j]));
            best[n][j] = __uint_as_float((__float_as_uint(v) & m) |
                                         (__float_as_uint(best[n][j]) & ~m));
            arg[n][j] = (int)(((unsigned)k & m) | ((unsigned)arg[n][j] & ~m));
        }
    }
}

// Dynamic shared memory of a step-block tile"""
_LOAD = """                        load_row<CPT>(nxt[u], logA + (size_t)min(lr + UNROLL + u, s1 - 1) * Kd,
                                      col, Kd, vec);"""


def _guard(src: str) -> str:
    """The unrolled groups with a test of every row, as first written."""
    a, b = src.index(_GROUPS_START), src.index(_GROUPS_END)
    return src[:a] + _GUARDED + src[b:]


def _edits(*pairs):
    def apply(src: str) -> str:
        for old, new in pairs:
            if old not in src:
                raise ValueError(f"the source no longer holds {old[:60]!r}")
            src = src.replace(old, new)
        return src
    return apply


VARIANTS = {
    "base": _edits(),
    "guard": _guard,
    "masked": _edits(("// Dynamic shared memory of a step-block tile", _MASKED_FOLD),
                     (_FOLD, _FOLD.replace("fold<LG, CPT, true>", "fold_masked<LG, CPT>"))),
    "lb3u4": _edits((_UNROLL, _UNROLL.replace("unroll_rows<LG>()", "4")),
                    ("__launch_bounds__(SB_THREADS, 2)", "__launch_bounds__(SB_THREADS, 3)")),
    "nocarry": _edits(("                    load_carry<LG>(d, s_c + (lr + u - k0) * LG);\n"
                       "                    fold<LG, CPT, true>(best, arg, d, cur[u], lr + u);",
                       "                    for (int n = 0; n < LG; ++n) "
                       "d[n] = __int_as_float(0x3f800000 + n + lr);\n" + _FOLD)),
    "noload": _edits((_LOAD, "                        for (int j = 0; j < CPT; ++j) nxt[u][j] = "
                             "__int_as_float(0x3f800000 + lr + u + j + col);")),
    "maxonly": _edits((_FOLD, _FOLD.replace("true>", "false>"))),
}


def measure(tag: str) -> None:
    import torch

    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km
    from flash_viterbi_tpu_torch.runtime import build

    build.kernels()
    fn = None
    with open(build.BUILD_LOG) as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
            fn = m.group(1) if m else fn
            b = re.search(r"step_block_kernelILi(\d+)E", fn or "")
            if b and ("Used" in line or ("spill" in line and " 0 bytes spill stores" not in line)):
                print(f"{tag} <{b.group(1)}> {line.strip().split('ptxas info    : ')[-1]}",
                      flush=True)
    dev = torch.device("cuda", 0)
    sms = km.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(32 * 2**20, device=dev)  # 128 MiB, more than the 50 MB L2

    def queued(f, k: int = 20, reps: int = 5) -> float:
        f()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            torch.cuda._sleep(40_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(k):
                f()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / k)
        return statistics.median(times)

    def cold(f, reps: int = 9) -> float:
        f()
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)
        events = []
        for _ in range(reps):
            flush.fill_(0.0)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)

    for N, Ks, Kd in SHAPES:
        d = torch.round(torch.randn((N, Ks), generator=g, device=dev) * 2) / 2
        blk = torch.round(torch.randn((Ks, Kd), generator=g, device=dev) * 2) / 2
        want = km.maxplus_step_block_plain(d, blk)
        default = km.step_plan(N, Ks, Kd, sms)
        ranges = (sorted({default.R, 1, 2, 4, 8, 16}) if Ks >= 3968 and Kd >= 992
                  else [default.R])
        line = f"{tag} ({N}, {Ks}, {Kd}), default R={default.R}:"
        for R in ranges:
            plan = km.step_plan(N, Ks, Kd, sms, R=R)
            got = km.maxplus_step_block(d, blk, plan=plan)
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            run = lambda: km.maxplus_step_block(d, blk, plan=plan)  # noqa: E731
            line += (f" R={R} ({plan.blocks} blocks){'' if same else ' MISMATCH'}: "
                     f"{queued(run):.4f} ms back to back, {cold(run):.4f} ms cold;")
        print(line, flush=True)
    if tag != "base":
        return
    from flash_viterbi_tpu_torch.probes import copy

    err = torch.zeros(1, dtype=torch.int32, device=dev)
    for x in (copy.fixture(device=dev), copy.beam_rows(device=dev)):
        out = torch.empty_like(x)
        runs = (("Tensor.copy_", lambda: out.copy_(x)),
                ("p1", lambda: copy.probe_copy_p1(x, err=err)),
                ("p3", lambda: copy.probe_copy_p3(x, err=err)))
        print(f"{tag} copies of {tuple(x.shape)}: " + "; ".join(
            f"{name} {queued(f):.4f} ms back to back, {cold(f):.4f} ms cold"
            for name, f in runs), flush=True)
    copy.raise_on(err, "copy probes")


def main() -> None:
    if len(sys.argv) > 3 and sys.argv[1] == "--one":
        sys.path.insert(0, sys.argv[3])
        measure(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    workdir = os.path.abspath(sys.argv[1])
    names = sys.argv[2:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with open(SOURCE) as f:
        source = f.read()
    for name in names:
        dst = os.path.join(workdir, name)
        shutil.rmtree(dst, ignore_errors=True)
        pkg = os.path.join(dst, "flash_viterbi_tpu_torch")
        shutil.copytree(os.path.join(ROOT, "flash_viterbi_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        with open(os.path.join(pkg, "csrc", "maxplus_scan.cu"), "w") as f:
            f.write(VARIANTS[name](source))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", name, dst],
                       check=True)


if __name__ == "__main__":
    main()
