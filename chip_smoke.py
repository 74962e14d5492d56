#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``flash_viterbi_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Device: the ``nvidia-smi`` name and power limit, and the torch device.
2. Build: compile the port's CUDA sources with ``nvcc``, one process per
   source, all at once.  Then four worker processes start (this script
   with ``--cpu-witness``, no card visible, 2 threads each) that make the
   port's CPU decodes phases 4, 8c, 8d and 12b hold the card's paths to,
   the SIEVE mirror fixtures' oracles, phase 6's paper FLASH-BS and phase
   8d's DAG tables, while the card's phases run.
3. Kernels: each of the eight kernels against its plain PyTorch version on
   the card, bit-exact (tolerance 0: the kernels use only correctly
   rounded fp32 adds, maxes and compares), at the headline shapes, at an
   unpadded K, on a fixture full of exact ties, and (the four PR 1
   kernels) at the batch phase's 64 lanes.  The beam scan is held on five
   fixtures: flash_bs's phase-1 shape (N=1, T'=255, Kp=3968, B=64, 7
   anchor planes), its segment shape (8 ragged lanes), the unpadded
   K=3965, sparse integer-valued ties (K=1000, B=128, fewer than B finite
   scores) and B=1; ``beam_topk``, the stable sort that makes a decode's
   first beam, and the plain scan are held to the kernel's select on a row
   of ties, -inf and -0.0 at B = 1, 128 and K=1000 (the full beam); the
   phase-1 shape under clusters forced to C = 1, 2 and 16 and with its
   state squeezed into the global scratch; Kp=17000 (B=64, T'=4) under
   its own plan and under C=2 (chunked folds), and its full beam (B=Kp,
   T'=2), whose state takes the scratch.  The argmax walk is also held at
   the recompute batch's N = 16 and 64 lanes (T'=255, timed) and with
   out-of-range last states; ``fold_planes`` (lean mode's and ``sieve_mp``'s
   fold of pointer rows into index planes, a cluster of G CTAs a plane)
   against its plain version and a numpy fold with the -1 rule, one launch
   a call, at lean phase 1's chunk of the headline (timed), at its largest
   round's shape at T=16384 (118 planes, a row each), at ``sieve_mp``'s top
   level (one plane, 128 rows), for one step, with every plane propagating
   or recording, the chunk under clusters forced to G = 1, 2, 8 and 16 and
   with records on either side of the groups' edges, out-of-range pointers
   (against the numpy fold alone), and at K=30000, whose maps leave shared
   memory, under its own plan and a cluster of 4, and the chunk under a plan
   squeezed into the scratch; the three decode shapes timed (one call, back
   to back, L2 flushed) beside their bounds, and one dependent pass of the
   fold (one CTA, 32 against 128 rows); a pointer chase through 60 MiB (the pointer
   walk over a random table) gives the dependent-load latency, and the
   walks' and the beam scan's latency floors from it (T' round trips).
   The three scans are also held on a parity grid, K in (64, 1024, 3965,
   4096, 16384) x N in (1, 16, 64), and under plans made for fewer SMs
   than their column groups (each block walking several tiles, both
   combines).  Times are the median of CUDA-event
   timings, each beside its bound (the bytes the function must move at
   3.35 TB/s, a scan's logA again every step where it exceeds what the
   card holds on chip, or its operations at the card's issue rate, 128 a
   clock an SM at its maximum SM clock, whichever is larger, counted from
   this run's inputs: ``flash_viterbi_tpu_torch/bench/bounds.py``); the
   emission-gather scan is also timed
   in turns with the pointer scan at the same shape.  After the probes:
   the card's L2 size and persisting limit, the persistent scan's fixed
   cost a step (K=128, T'=255), the rate at which it streams a logA of the
   headline scan's streamed part's size (all of it in L2, no row in shared
   memory), each scan's design floor from those two, and both combines in
   turns at 1 to 16 lanes, K=3968 and K=16384.
4. FLASH slice: the headline problem (K=3965 padded to 3968, M=50, T=256,
   prob=0.112, seed=1) decoded for four requests through the public
   ``decode(..., "flash", num_segments=16, device="cuda")``.  Each path
   must equal the port's CPU decode bit for bit, and the native C vanilla
   oracle exactly or, for FLASH's legitimate fp32 tie flips, within the f64
   score tolerance (the seed-1 request exactly).  Phases 4-6 first keep the
   card busy for half a second (the clocks after host work), and phases 4
   and 5 time request 0 again after the others.
5. Checkpoint slice: the same four requests through ``decode(...,
   "checkpoint")`` and ``decode(..., "fused")`` on the card; checkpoint
   must equal fused bit for bit and the C oracle under the rule above, and
   each ``memory:`` figure its analytic value.
6. Beam: the four requests through ``decode(..., "flash_bs",
   beam_width=64, num_segments=8)`` and ``decode(..., "beam",
   beam_width=64)``; each path must equal the port's CPU decode and its
   numpy mirror exactly (-1 segments included), and ``memory:`` its
   analytic value (12656 and 133120); request 0's two paths must pass
   ``beam_path_invariants`` (valid states or -1, a finite quirk-scored
   f64).  The f64 score gap to the C vanilla oracle's path is printed, as
   information on beam quality, and where request 0's flash_bs path equals
   the paper's FLASH-BS (``oracle.reference.flash_bs``, the C program's
   min-heap recursion at B=64 and 8 threads, made by a witness worker),
   with both counts of -1.  Then one
   ``decode(..., "beam", beam_width=64)`` at K=17000, T=32, whose select
   does not fit a block's shared memory, against the port's CPU decode.
7. Long T: T=16384 through the registered checkpoint and fused decoders on
   tables already on the card; equal paths, and the checkpoint decode's
   peak allocation under 32 MiB above what was allocated before it.
8. Batch: ``decode_batch(..., "fused")`` over 16 and 64 sequences in both
   pointer modes; every row must equal that sequence's single decode.
8b. Lean, auto and the harness (its wall time printed):
   the four requests through ``decode(..., "flash", mode="lean",
   num_segments=16)`` and request 0 at ``lean_leaf=0``: each path equals
   the C oracle or, on a mismatch only, the f32 FLASH mirror
   (``arbitrate_flash_tie_flip`` says "mirror-exact"); request 0 equals the
   port's CPU lean decode; ``memory:`` its analytic value; lean launches
   only the scan, the deltas scan, the walk and ``fold_planes`` (only the
   scan and the fold at leaf 0); each peak allocation above the tables
   (after a warmup call, which also makes the decoder's transposed logA)
   within ``auto.device_working_set``'s lean formula.  Lean at T=16384 on
   the headline tables: within ``dp_divergence_tolerance_f64`` of fused's
   path by f64 score, its peak within the formula, timed beside fused and
   checkpoint.  docs/DESIGN.md section 1 (K=512, T=2048, seed 1, N=16):
   lean equals the f32 mirror bit for bit, pointer mode is mirror-exact or
   tie-equivalent, each one's positions off vanilla printed.
   ``decode(..., "auto")`` on the four requests, T=16 and T=16384 at the
   headline K, K=1024 at T=256, the headline under a budget one byte
   below its choice's working set, and K=8192, T=1024 with 128 segments
   under a budget of lean's working set, which must choose lean: each path
   equals its chosen decoder's
   own decode on the card, the C oracle under phase 4's rule where K^2 T
   <= 2e10, and ``memory:`` the chosen decoder's figure.  The harness's
   ``sweep`` at the headline over vanilla, flash, flash lean, checkpoint,
   fused, flash_bs, beam and auto: every parity True, "mirror-exact" or
   "tie-equivalent", every CSV header ``CSV_FIELDS``.
8c. SIEVE (its wall time printed): the four requests through ``decode(...,
   "sieve_mp")`` and ``decode(..., "sieve_bs_mp", beam_width=64)``, and
   request 0 at ``prune=False``: request 0 of each equals the port's CPU
   decode bit for bit (its host time in the witness printed), ``memory:`` its analytic
   value; each path's positions off the C vanilla oracle and f64 score
   are printed as information (the right child's re-argmax may score
   -inf), and request 0's peak allocation above the tables beside the
   analytic figure.  ``sieve_mp``
   launches only the scan and ``fold_planes``, ``sieve_bs_mp`` only the
   scan.  Mirror fixtures (the headline's M, prob, seed and T at K=1024
   for ``sieve_mp``, K=512 for ``sieve_bs_mp``, the harness's
   ``_MIRROR_MAX_K``): each path equals its copied oracle.  A tie
   fixture (``make_tie_hmm``: uniform rows, an all -inf column, K=300,
   T=64) equals the CPU decode and the oracles.  The scan at every lane count 1..128 a headline
   level gives and at 8192 lanes (T=16384's deepest level) equals its
   plain version, all -inf columns pointing at 0.  ``decode(...,
   "sieve_bs", beam_width=64)`` (no hand kernel: none may launch) on
   request 0 equals the port's CPU decode bit for bit, ``memory:`` its
   analytic value; its time, device busy time, idle share and kernel
   launches (torch.profiler), peak allocation beside ``memory:``, the
   tree's nodes and levels, the b-hop searches' hops and the host BFS's
   time are printed; at K=512 it equals the float64 SIEVE-BS oracle, and
   with a beam of 2 at K=61, M=6, T=24, prob=0.19, seed 1 (a node whose
   every median candidate the beam prunes) the fp32 framework mirror, its
   ``(-1, -1)`` pair included.  The harness's ``sweep``
   at the mirror fixtures: parity True, headers ``CSV_FIELDS``.
8d. Dynamic SIEVE (its wall time printed; no hand kernel may launch):
   ``decode(..., "sieve")`` on request 0 (one decode, no warmup) and
   ``decode(..., "sieve_dag")`` on a K=4096, T=64 DAG (``make_dag_hmm``,
   seed 1), each held by invariants (every pair an edge of A, the path
   the pairs' layout, ``memory:`` its analytic value, a second run equal),
   with its time, peak above the tables beside ``memory:``, nodes, levels,
   node-steps and the device ms of its counts and children's searches
   printed; request 0's first 32 symbols against the port's CPU decode,
   ``sieve`` at K=512, T=96 against the float64 oracle, ``sieve_dag`` at
   K=2048, T=64 against the CPU decode and at K=1024, T=32 against the
   float64 oracle; last, the device busy time, idle share and launches
   (torch.profiler) of the 32-symbol decode and of the K=4096 one.
8e. ``flash_long``: the four requests through ``decode(..., "flash_long",
   num_segments=4)``, each equal to ``flash`` pointer mode at 4 segments
   on the card and the C oracle under phase 4's rule, ``memory:`` flash's;
   T=16384 on the headline tables at ``group_steps`` 1024, 4096 and
   16384, each equal to flash pointer mode's path, with its time and peak.
8f. Routes (its wall time printed): ``decode(..., "fused")`` at K=1280,
   1536, 2048 and 2176, T=256, ``decode_batch(...,
   "fused")`` at K=256, T=256, Bs=2 and 3 and K=8192, T=8, Bs=4 and 5,
   and ``decode(..., "checkpoint")`` at K=1024, T=1024: each launches the
   route ``fused.pointer_route`` names (both routes among each rule's
   sides), or the chunks of ``checkpoint.snapshot_step``, and its path
   equals the port's CPU decode; each one's two routes (steps) are timed
   in turns.
9. Sharded, one rank: ``decode_batch(hmm, requests, mesh=make_mesh(1, 1,
   1), num_segments=16, device="cuda")`` on the four headline requests;
   every row must equal the C oracle under the rule of phase 4, request 0
   the port's CPU sharded decode bit for bit, ``memory:`` 4 x flash's.
10. Sharded, several ranks on the one card: meshes (1, 1, 2) and (1, 2, 2)
   over gloo (``launch_workers`` starts this script once a rank, with
   arguments), every rank on ``cuda:0`` holding only its column shard of
   ``logA`` and ``logB``; each rank's paths must equal phase 9's bit for
   bit.  Per-rank times are of ranks time-sliced on one card, not of
   several cards.  Each world then runs 3 fuzz draws of its size (phase
   12c).
11. Config-5's K: K=16384, M=50, prob=0.112, seed=1, 2 sequences in one
   microbatch, 16 segments, T cut from 65536 to 4096 (8 chunks of 512) to
   keep the run short; mesh (1, 1, 1) in this process, then (1, 1, 4) as 4 ranks on the
   card, each memory-mapping the tables from ``.npy`` files and uploading
   only its 256 MiB column shard.  Equal paths, in range, finite scores.
   Between the two, ``decode_batch(..., "flash_long", num_segments=16)``
   (the batched pipeline) on the same tables equals ``decode_batch(...,
   "flash")``; its time and peak above the tables are printed.  Then
   ``scripts/torch_config5.py``'s functions on the same tables, T cut to
   2048, at 1 and 4 segments: 4 sequences in batches of 2 into a
   temporary score file, gates 1-3 holding; a resumed call to 6 sequences
   decodes only sequences 4 and 5 (half the first call's launches); the
   resumed file's scores and paths equal a fresh 6-sequence run's.  The
   step's time is printed.

12. The command line and tools (its wall time printed), at the headline:
   ``cli.main(["decode", "-a", "fused", ...])`` (the reference stdout
   protocol: the path equals request 0's C oracle, ``memory:`` fused's
   analytic value, its time beside ``scaling.single_chip_wall_model``);
   ``generate`` then ``decode --data`` at K=512 against the C oracle of
   the written files; ``bench -a fused,flash`` into a temporary
   ``--csv-dir`` (header ``CSV_FIELDS``, parity); ``compare`` in a
   temporary directory (vanilla, checkpoint and fused equal the C oracle,
   flash at 8 segments under phase 4's rule, flash_bs and beam phase 6's
   paths, sieve_mp the CPU decode, the SIEVE oracles skipped above
   ``--oracle-limit``); the headline script
   (``flash_viterbi_tpu_torch.bench.headline``, exact path parity,
   ``bench.py``'s keys); ``scaling --mesh "1,1,2;1,2,2" --measure`` (each
   mesh as gloo ranks on the card, every row's paths equal);
   ``profile_flash`` at 16 segments (0 < phase 1 <= the whole decode);
   ``memory_report`` after a fused decode; ``decode(..., retries=2)``
   equal to the decode without.  Phase 7 also prints the model's T=16384
   wall beside fused's.
12b. ``precision="bf16"`` (its wall time printed; after phase 11, before
   13): the bf16-table instances of the pointer scan, the deltas scan and
   the walk against their plain versions on the card, bit for bit (the
   sums are fp32 of the bf16 values in both): at the flash decode's shapes
   (timed, each beside its bound: the bf16 table counts at 2 bytes a
   value), the walk also at N=1, T'=255, at the unpadded K=3965, on a
   dense-tie table of four bf16 values (K=1000, 20 lanes, ragged mask) and
   on the parity grid (the walk over each deltas scan's history).  Then
   the four requests through ``decode(..., precision="bf16")`` for
   ``fused``, ``flash`` (16 segments) and flash lean: each launches its
   bf16 kernels and no fp32 scan or walk, each path equals the port's CPU
   bf16 decode (made by the witness workers) bit for bit, ``memory:`` the
   decoder's figure, and its positions and f64 score gap to the C oracle's
   exact path are printed; ``auto`` in bf16 chooses fused and equals it;
   ``decode_batch(..., "fused", precision="bf16")`` over 16 sequences in
   both pointer modes, every row equal to its single bf16 decode on the
   card (rows 0-3, the requests, to the CPU's).  Last, fp32 against bf16
   in turns: the two scans' µs a step, the fused, flash, lean and
   recompute Bs=16 decodes, and the flash decoder's kept tables and peak;
   each decode's device busy ms (torch.profiler) is read in phase 13's
   fresh process.
12c. Fuzz (its wall time printed; after 12b): fixed draws of the port's
   fuzz scripts through the public decoders on the card, every path held as
   the scripts hold it (``scripts/torch_fuzz_midscale.py``: the C oracle,
   the tie-flip arbitration, the numpy mirrors, the fp32 decode of the
   bf16-rounded table; ``scripts/torch_fuzz_engines.py``: the port's CPU
   decode and the oracles): 8 midscale draws (seeds 90000-90007), 8 small
   (50000-50007), 4 wide (K 2135, 3476, 4340 and 4109), the wide draws' C
   oracle made by the witness workers, and 3 engine draws (``sieve_bs``,
   ``sieve`` / ``sieve_dag``, a batch of three; the CPU decodes and oracles
   in the witness workers).  Every kernel of each regime's paths must
   launch, none of the engine draws'.  The coverage line (scan plans, the
   bf16 tile copy's paths, the beam and fold clusters) is printed.  Phase
   10's rank worlds also run the first 3 sharded draws of distinct meshes
   of their size (``scripts/torch_fuzz_sharded.py``), each rank against
   the single-device flash decode on the card.
12d. The paper's SIEVE-BS run: ``decode(..., "sieve_bs", beam_width=32)``
   on request 0 (``scripts/torch_sieve_bs_witness.py``'s part 1; no hand
   kernel may launch): its -1 sentinels, quirk-scored f64 score and
   junction breaks must equal the JAX package's record,
   ``results/sieve_bs_witness.log``, exactly.  It runs after the last
   torch.profiler session of this process (8d's): a session records
   fewer of its kernels the more the process launched before it
   (``scripts/torch_profiler_records.py``), and the decode launches ~100k.
13. Last, ``device_trace`` around one fused decode, in a fresh process
   (this script with ``--trace``): a Chrome trace holding each launch of
   its two hand kernels (host timings after a profiler session run
   slower, and a session after the earlier phases in this process has
   recorded only some of the decode's kernels, or none: it records fewer
   the more the process launched before it,
   ``scripts/torch_profiler_records.py``).  The same process then reads
   12b's device busy ms of the fused, flash, lean and recompute Bs=16
   decodes in fp32 and bf16.

The kernel phase also holds ``maxplus_step_block`` bit-exact on nine
fixtures: the (1, 1, 1) boundary step (N=1, Ks=Kd=3968), 16 phase-2 lanes
on one of 4 state ranks (Kd=992), config-5's K on one of 4 state ranks
(Ks=16384, Kd=4096), the (1, 1, 2) and (1, 2, 2) meshes' shard steps
(Kd=1984 at N = 1, 16 and 8), the 16-lane step under a plan of more tiles
than SMs and under one of a single source range (no cluster), and an
integer-valued tie fixture (N=20, Ks=1000, Kd=250, duplicated source rows,
an all -inf source row and column), whose two lane groups must make one
launch.  Each timed shape is timed back to back, as a sharded decode calls
it (the shard stays in L2 where it fits), and with L2 flushed before each
call.

Probes (after the kernel phase): the counterparts of the JAX package's
``scripts/`` probes (``flash_viterbi_tpu_torch.probes``).  Every probe
kernel that computes a defined function is held bit-exact against its
plain version on the card: the add+max chains at R=64 and R=4096, also
on an odd element count with the clock readout on; the scan ablation's
``full``, ``no-hist`` and ``all-streamed`` (instances of the production
persistent scan) on its five shapes, the TPU probe's three and the
headline decode's two scans (K=16384 compared at T'=4: the plain
version's (K, K) temporary is 1 GiB a lane-step); the beam probes (instances of the
production beam scan's cluster kernel) ``full``, ``sort``, ``pick``,
``nosmem`` and ``blockm`` against the plain beam scan and the production
``beam_scan`` on the probes' fixture and on a tie fixture,
p1 and p3 on the TPU probe's fixture and on a beam scan's rows, each under
the card's plan and under plans of 1 and 3 CTAs (long runs of steps, every
ring stage's barrier through many phases), p4, p5 on its forced tie; p4 as
a cluster at (Tm, W, C) = (4, 8, 1), (255, 32, 1), (255, 512, 16), (255,
512, 8) and (255, 16, 16) by both publishes (``st.async`` onto each
CTA's mbarrier, one ``cluster.sync()`` a step), a value per step and
slot, and p5 as a cluster at (n, C) = (256, 1), (3968, 1), (3968, 16) on
a tie won in the first CTA's shard and on one won in the last, each with
CTA 0's clock read back, and p5's cluster on the TPU fixture against the
old p5.
p1's and p3's time at both shapes is printed beside ``Tensor.copy_``'s,
timed alike: the device's time a call back to back (chains queued behind a
sleep of the card, no host read inside a chain: the records' ``ms`` and
``library_ms``), with L2 flushed, and the slope of chains with the host's
launch cost in it.  Then the probe path, ``probes.run()``, is driven between a
reset and a read of the launch counters: every probe kernel must launch.
Each variant's time is printed beside its bound, counted as in
``compare``; the beam probes' variants in us a step with their cluster
size, and ``full``, ``no-pick`` and ``no-fold`` again at B = 1, 16 and 256,
which split a step into its skeleton, the rows and fold a beam row, and
the select; each scan-ablation shape's step split (fixed cost, combine,
streamed rows and their rate, fold, history); ``probe_alu``'s device time,
cycles a call, cells a clock an SM and implied SM clock beside its two
targets, and the scans' operation bound at the issue rate and at the
measured add+max rate; the chases' cycles a dependent step (shared memory,
a peer CTA's shared memory, a shuffle, a winner's compare), an empty
kernel's device time back to back (the launch floor), each cluster probe's
device time back to back, CTA 0's cycles a step or a call, its
dependent-chain floor (``bench/bounds.py``) and share, and at C=16 the
cycles of a ``cluster.sync()`` publish against a remote-mbarrier one,
times the beam step's five barriers, against the beam probes' step.

Launch counters are set to 0 before each phase and read after it; every
kernel of that phase's path must have launched.  Prints a ``{"kernels":
[...]}`` JSON line (launches summed over the decode phases of this
process, and the probe kernels' over the probe path; ``latency_floor_ms``
the dependent-chain floor where a kernel's row states one, else null),
then, last, the
``{"ok": true, "device": {...}}`` line.  Imports no JAX.
"""

from __future__ import annotations

import ast
import contextlib
import io
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from flash_viterbi_tpu_torch.bench.harness import queued_ms

HEADLINE = dict(K=3965, M=50, T=256, prob=0.112, seed=1)
SEGMENTS = 16
EXTRA_SEEDS = (2, 3, 4)
LONG_T = 16384
LONG_T_PEAK_BYTES = 32 * 2**20
BATCHES = (16, 64)
BEAM_WIDTH = 64
BEAM_SEGMENTS = 8
BEAM_MEMORY = {"flash_bs": 12656, "beam": 133120}
# the paper's FLASH-BS (the C program's min-heap recursion, its numpy mirror
# oracle.reference.flash_bs) at flash_bs's beam and segments, on request 0:
# printed beside the card's flash_bs, whose semantics are the framework's
C_FLASH_BS = {"beam_width": BEAM_WIDTH, "threads": BEAM_SEGMENTS, "numerics": "f32"}
# a beam decode above the K whose select fits one block (Kp <= 16384 at
# B=64): the headline's M, prob and seed, T cut to 32
BEAM_LARGE = dict(K=17000, M=50, T=32, prob=0.112, seed=1)
# the scans' parity grid: every K by every lane count, T' steps (4 at
# K=16384, where the plain version's temporary is 1 GiB a lane-step)
GRID_K = (64, 1024, 3965, 4096, 16384)
GRID_N = (1, 16, 64)
GRID_TM = 8
GRID_TM_LARGE = 4
# backtrack_batched's shapes (T', N, K) on the main path: fused and flash at
# the headline, fused at T=16384, checkpoint's segments at T=256 (16 rows and
# a last of 15) and T=16384 (256 and 255), beam (K = B = 64), the store
# batches of 16 and 64, a flash_long group at config-5's K=16384; the lane
# counts whose paths meet planted entries; the grid's T' besides a plan's L
BACKTRACK_SHAPES = ((255, 1, 3968), (16383, 1, 3968), (16, 1, 3968), (15, 1, 3968),
                    (256, 1, 3968), (255, 1, 64), (255, 16, 3968), (255, 64, 3968),
                    (4096, 1, 16384))
BACKTRACK_PLANTED = ((255, 1, 3968), (255, 16, 3968), (15, 16, 3968), (1024, 4, 16384))
BACKTRACK_GRID_TM = (1, 255)
# (K, N, SMs) whose plans walk several tiles a block; the combine turns' shapes
LOOPED_PLANS = ((3000, 16, 4), (3000, 20, 4), (3001, 1, 1))
COMBINE_SHAPES = ((3968, 1), (3968, 2), (3968, 4), (3968, 8), (3968, 16), (16384, 1),
                  (16384, 2), (16384, 16))
RANK_MESHES = ((1, 1, 2), (1, 2, 2))
# the step block's shard shapes on those meshes, (N, Kd) against the whole
# carry (a spy on the CPU decode: (1, 1, 2) steps N=1 1024 times and N=16
# 60 times a rank, (1, 2, 2) N=1 640 times and N=8 60 times)
STEP_SHARD_SHAPES = ((1, 1984), (16, 1984), (8, 1984))
# source ranges of a step-block plan whose tiles outnumber the SMs
STEP_MANY_RANGES = 16
# config-5 (K=16384, T=65536, 256 sequences) with T cut to 4096 and 2
# sequences: its K, the size state sharding exists for, in a short run;
# both sequences in one microbatch, so each trellis step serves both
CONFIG5 = dict(K=16384, M=50, T=4096, prob=0.112, seed=1)
CONFIG5_BATCH = 2
CONFIG5_MICROBATCH = 2
CONFIG5_MESH = (1, 1, 4)
# scripts/torch_config5.py on those tables: T cut to 2048, a first call of
# 4 sequences in batches of 2, a resumed call to 6, at each segment count
CONFIG5_SCRIPT = dict(T=2048, first=4, resumed=6, batch=2, segments=(1, 4))
RANK_TIMEOUT_S = 300.0
# the fused decode's hand kernels, each wrapper's counter against the
# name its kernel has in the profiler's trace
TRACE_KERNELS = {"maxplus_scan": "scan_persistent", "backtrack_batched": "backtrack_kernel"}
# the fold at sieve_mp's top level: the rows after the midpoint of a T=256
# request; the phase-1 chunk under these forced cluster sizes
FOLD_TOP_ROWS = 128
FOLD_FORCED_G = (1, 2, 8, 16)
# lean mode's kernels at the default leaf, and at lean_leaf=0 (rounds only)
LEAN_NEEDS = ("maxplus_scan", "maxplus_scan_deltas", "argmax_walk", "fold_planes")
LEAN_ONLY_ROUNDS = ("maxplus_scan", "fold_planes")
# docs/DESIGN.md section 1's tie-flip fixture (N=16): the C recursion flips 5
DESIGN_CHECK = dict(K=512, M=50, T=2048, prob=0.112, seed=1)
# auto's shapes beside the four headline requests: (K, T) on the headline's
# M, prob and seed (the headline tables where K is the headline's)
AUTO_SHAPES = ((3965, 16), (3965, 16384), (1024, 256))
# (K, T, overrides) where a budget of lean's working set chooses lean: lean
# leads checkpoint there, and its many short segments keep its working set
# under fused's (auto.py's LEAN_MIN_K .. LEAN_MAX_T)
AUTO_LEAN = (8192, 1024, {"num_segments": 128})
# the C oracle's trellis cells at most (as the harness's _ORACLE_MAX_CELLS)
ORACLE_MAX_CELLS = 2e10
HARNESS_OK = (True, "mirror-exact", "tie-equivalent")
# the SIEVE decoders' kernels, and their oracles' largest K (the harness's
# _MIRROR_MAX_K): the mirror fixtures are the headline's M, prob, seed and T
SIEVE_NEEDS = {"sieve_mp": ("maxplus_scan", "fold_planes"), "sieve_bs_mp": ("maxplus_scan",),
               "sieve_bs": ()}
SIEVE_MIRROR_K = {"sieve_mp": 1024, "sieve_bs_mp": 512, "sieve_bs": 512}
SIEVE_STATIC = {"sieve_mp": {}, "sieve_bs_mp": {"beam_width": BEAM_WIDTH},
                "sieve_bs": {"beam_width": BEAM_WIDTH}}
# sieve_bs with a beam of 2 on a fixture where it prunes every median
# candidate of a node (the reference crashes there; the decoder emits
# (-1, -1)): held to the fp32 framework mirror
SIEVE_BS_SENTINEL = (dict(K=61, M=6, T=24, prob=0.19, seed=1), 2)
# the dynamic-median SIEVE decoders (no hand kernel): the headline request's
# prefix held to the port's CPU decode (and profiled: the whole request
# makes ~1.1M kernels, more events than torch.profiler processes in
# minutes); DYN_FIXTURES: (decoder, problem, what the card's path is held
# to: "cpu" the port's CPU decode, "oracle" the float64 oracle, None
# nothing, a problem held by invariants), whose tables and paths the
# witness workers make (a K=4096 DAG takes ~2 min of the host without
# networkx), each held path's host work under a minute
SIEVE_DYN_PREFIX = 32
DYN_FIXTURES = {"sieve_oracle": ("sieve", dict(HEADLINE, K=512, T=96), "oracle"),
                "dag_large": ("sieve_dag", dict(K=4096, M=50, T=64, seed=1), None),
                "dag_cpu": ("sieve_dag", dict(K=2048, M=50, T=64, seed=1), "cpu"),
                "dag_oracle": ("sieve_dag", dict(K=1024, M=50, T=32, seed=1), "oracle")}
# flash_long: its segments at the headline and at long T, the group sizes
# the long-T row sweeps, and its kernels alone and batched
LONG_SEGMENTS = 4
LONG_GROUPS = (1024, 4096, 16384)
LONG_NEEDS = ("maxplus_scan", "maxplus_scan_deltas", "backtrack_batched", "argmax_walk")
LONG_BATCH_NEEDS = ("maxplus_scan_deltas", "argmax_walk")
# phase 8f: each routing threshold's two sides (fused.pointer_route,
# checkpoint.snapshot_step), held to the port's CPU decode
ROUTE_KERNELS = {"store": ("maxplus_scan", "backtrack_batched"),
                 "recompute": ("maxplus_scan_deltas", "argmax_walk")}
ROUTE_SINGLE = ((1280, 256), (1536, 256), (2048, 256), (2176, 256))  # (K, T)
ROUTE_BATCH = ((256, 256, 2), (256, 256, 3), (8192, 8, 4), (8192, 8, 5))  # (K, T, Bs)
ROUTE_SNAPSHOT = (1024, 1024, 32)  # (K, T, the step of the rule SNAPSHOT_MIN_STEP replaced)
# the port's CPU decodes that the card's headline paths are held to bit for
# bit, and the SIEVE mirror fixtures' oracles (request None), made by
# worker processes (``witness_main``) while the card's phases run: (tag,
# decoder, request, static keywords) a worker, in the order the phases read
# them.  The CPU decodes gain little from more threads (the plain scan goes
# a lane at a time): four workers of 2 threads each, to finish before the
# phases that read them
# precision="bf16" (phase 12b): its kernel instances' launch counters, the
# headline decodes it drives (label, decoder, keywords, the kernels each must
# launch, and launch alone), and the batch's pointer modes with theirs
BF16_SCAN, BF16_DELTAS, BF16_WALK = "maxplus_scan_bf16", "maxplus_scan_deltas_bf16", \
    "argmax_walk_bf16"
BF16_DECODES = (
    ("fused", "fused", {}, (BF16_SCAN, "backtrack_batched")),
    ("flash", "flash", {"num_segments": SEGMENTS},
     (BF16_SCAN, BF16_DELTAS, "backtrack_batched", BF16_WALK)),
    ("lean", "flash", {"mode": "lean", "num_segments": SEGMENTS},
     (BF16_SCAN, BF16_DELTAS, BF16_WALK, "fold_planes")))
BF16_BATCH = 16
BF16_BATCH_NEEDS = {"store": (BF16_SCAN, "backtrack_batched"),
                    "recompute": (BF16_DELTAS, BF16_WALK)}


def _bf16_jobs(label: str, requests) -> tuple:
    """Witness jobs: the CPU bf16 decodes of BF16_DECODES[label] on
    ``requests``, tagged ``bf16_<label><i>``."""
    _, name, static, _ = next(d for d in BF16_DECODES if d[0] == label)
    return tuple((f"bf16_{label}{i}", name, i, {**static, "precision": "bf16"})
                 for i in requests)


# the fuzz phase (12c): fixed draws of the port's fuzz scripts
# (scripts/torch_fuzz_*.py), the same in every run: the first 8 of the
# midscale and small regimes' default runs, 4 wide draws (the first two at
# K <= 4096, K 2135 and 3476, and the first two above, 4340 and 4109), the
# first 3 engine draws and the first 3 sharded draws of distinct meshes of the
# worlds of 2 and 4 ranks, which join the rank worlds of phase 10
FUZZ_MIDSCALE = tuple(range(90_000, 90_008))
FUZZ_SMALL = tuple(range(50_000, 50_008))
FUZZ_WIDE = (70_001, 70_004, 70_000, 70_002)
FUZZ_ENGINES = 3
FUZZ_SHARDED = 3
FUZZ_NEEDS = ("maxplus_scan", "maxplus_scan_deltas", "maxplus_scan_emitgather",
              "backtrack_batched", "argmax_walk", "fold_planes")
FUZZ_BEAM_NEEDS = ("beam_scan",)             # the draws with a beam check
FUZZ_BF16_NEEDS = (BF16_SCAN, BF16_DELTAS, BF16_WALK)  # the draws with a bf16 check


def _fuzz_jobs(worker: int) -> tuple:
    """Witness jobs of the fuzz phase on worker ``worker``: the C oracle of
    the wide draws and the engine draws' CPU decodes and oracles."""
    return (tuple((f"fuzz_wide{i}", "fuzz_wide", i, {})
                  for i in range(len(FUZZ_WIDE)) if i % 4 == worker)
            + tuple((f"fuzz_engines{i}", "fuzz_engines", i, {})
                    for i in range(FUZZ_ENGINES) if i % 4 == worker))


WITNESS_JOBS = (
    tuple((f"flash{i}", "flash", i, {"num_segments": SEGMENTS})
          for i in range(1 + len(EXTRA_SEEDS)))
    + (("c_flash_bs0", "c_flash_bs", 0, C_FLASH_BS),)
    + tuple((f"mirror_{name}", name, None, SIEVE_STATIC[name]) for name in SIEVE_MIRROR_K)
    + _bf16_jobs("fused", range(4)) + _bf16_jobs("lean", (0,)) + _fuzz_jobs(0),
    (("sieve_mp", "sieve_mp", 0, {}), ("sieve_bs", "sieve_bs", 0, SIEVE_STATIC["sieve_bs"]),
     ("sieve_prefix", "sieve", "prefix", {})) + _bf16_jobs("flash", (0, 1)) + _fuzz_jobs(1),
    (("sieve_bs_mp", "sieve_bs_mp", 0, SIEVE_STATIC["sieve_bs_mp"]),
     ("sieve_mp_unpruned", "sieve_mp", 0, {"prune": False}),
     ("sieve_oracle", "sieve", "sieve_oracle", {})) + _bf16_jobs("flash", (2, 3))
    + _fuzz_jobs(2),
    tuple((key, DYN_FIXTURES[key][0], key, {}) for key in ("dag_large", "dag_cpu", "dag_oracle"))
    + _bf16_jobs("lean", (1, 2, 3)) + _fuzz_jobs(3))
WITNESS_THREADS = 2
WITNESS_TIMEOUT_S = 600.0
# PR 6's first request of each decode phase read ~2x the others, after
# seconds of host work (C oracle, CPU decodes): the phases spin the card
# up first and time request 0 again after the others
SPIN_UP_S = 0.5
SHARDED_NEEDS = ("maxplus_step_block", "maxplus_scan", "backtrack_batched",
                 "maxplus_scan_deltas", "argmax_walk")

# the command line and tools phase: the kernels its decodes must launch (the
# headline script's flash, compare's checkpoint, beam decoders and sieve_mp),
# the K of its generate/decode --data round trip (the headline's tables as
# text are ~150 MB), the meshes of its scaling sweep, and bench.py's keys,
# which the headline script's line must hold
TOOLS_NEEDS = ("maxplus_scan", "maxplus_scan_deltas", "maxplus_scan_emitgather",
               "backtrack_batched", "argmax_walk", "beam_scan", "fold_planes")
TOOLS_DATA_K = 512
TOOLS_MESHES = "1,1,2;1,2,2"
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "wall_s", "config",
              "exact_path_parity", "device")

# torch.profiler sessions of device_profile at most: one thrown away, then
# until one records device time
PROFILE_SESSIONS = 4
# the error word the kernel phase's timed beam scans and walks share
SHARED_ERR = None

# kernel name -> (CUDA source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "maxplus_scan": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                     "flash_viterbi_tpu/ops/pallas/maxplus.py:467"),
    "maxplus_scan_deltas": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                            "flash_viterbi_tpu/ops/pallas/maxplus.py:240"),
    "maxplus_scan_emitgather": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                                "flash_viterbi_tpu/ops/pallas/maxplus.py:597"),
    "maxplus_step_block": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                           "flash_viterbi_tpu/ops/pallas/maxplus.py:720"),
    "backtrack_batched": ("flash_viterbi_tpu_torch/csrc/backtrack.cu",
                          "flash_viterbi_tpu/ops/pallas/backtrack.py:123"),
    "argmax_walk": ("flash_viterbi_tpu_torch/csrc/argmax_walk.cu",
                    "flash_viterbi_tpu/ops/pallas/backtrack.py:594"),
    "beam_scan": ("flash_viterbi_tpu_torch/csrc/beam_scan.cu",
                  "flash_viterbi_tpu/ops/pallas/beam.py:205"),
    # not a Pallas kernel: the lax.scan that folds pointer rows into lean
    # mode's anchor planes (and, at :401, its t2 planes)
    "fold_planes": ("flash_viterbi_tpu_torch/csrc/fold_planes.cu",
                    "flash_viterbi_tpu/algorithms/flash.py:190"),
    # the bf16-table instances (precision="bf16"): the Pallas scans load a
    # bf16 tile (maxplus.py:132, :196), the walk reads bf16 logAT rows
    BF16_SCAN: ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                "flash_viterbi_tpu/ops/pallas/maxplus.py:467"),
    BF16_DELTAS: ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                  "flash_viterbi_tpu/ops/pallas/maxplus.py:240"),
    BF16_WALK: ("flash_viterbi_tpu_torch/csrc/argmax_walk.cu",
                "flash_viterbi_tpu/ops/pallas/backtrack.py:594"),
}
# the probes' kernels (flash_viterbi_tpu_torch/probes/), the same way
PROBE_KERNELS = {
    "probe_alu": ("flash_viterbi_tpu_torch/csrc/probe_alu.cu", "scripts/vpu_probe.py:67"),
    "probe_scan_ablation": ("flash_viterbi_tpu_torch/csrc/maxplus_scan.cu",
                            "scripts/vpu_probe.py:142"),
    "probe_beam_parts": ("flash_viterbi_tpu_torch/csrc/probe_beam.cu",
                         "scripts/beam_profile.py:120"),
    "probe_beam_select": ("flash_viterbi_tpu_torch/csrc/probe_beam.cu",
                          "scripts/beam_profile2.py:161"),
    "probe_copy_p1": ("flash_viterbi_tpu_torch/csrc/probe_copy.cu",
                      "scripts/beam_dma_probe.py:52"),
    "probe_copy_p3": ("flash_viterbi_tpu_torch/csrc/probe_copy.cu",
                      "scripts/beam_dma_probe.py:98"),
    "probe_copy_p4": ("flash_viterbi_tpu_torch/csrc/probe_copy.cu",
                      "scripts/beam_dma_probe.py:126"),
    "probe_copy_p5": ("flash_viterbi_tpu_torch/csrc/probe_copy.cu",
                      "scripts/beam_dma_probe.py:154"),
    "probe_copy_p4_cluster": ("flash_viterbi_tpu_torch/csrc/probe_copy.cu",
                              "scripts/beam_dma_probe.py:126"),
    "probe_copy_p5_cluster": ("flash_viterbi_tpu_torch/csrc/probe_copy.cu",
                              "scripts/beam_dma_probe.py:154"),
}
# the record of probes.run() whose time stands for each probe kernel: the
# production configuration where there is one, else the beam scan's rows
PROBE_TIMED = {"probe_alu": "vpu_peak", "probe_scan_ablation": "phaseA_full",
               "probe_beam_parts": "full", "probe_beam_select": "pick",
               "probe_copy_p1": "p1_beam_rows", "probe_copy_p3": "p3_beam_rows",
               "probe_copy_p4": "p4", "probe_copy_p5": "p5",
               "probe_copy_p4_cluster": "p4c_beam_c16_mbarrier",
               "probe_copy_p5_cluster": "p5c_carry_row_c16"}
# the beam step's cluster barriers a step (beam_cluster.cuh's radix select:
# up to five): the cluster publishes at C=16 times these are set against the
# beam probes' full step at one lane
BEAM_STEP_BARRIERS = 5
# the beam probes' sweep over the beam width (the TPU probe's B parameter)
BEAM_SWEEP_B = (1, 16, 64, 256)
BEAM_SWEEP_VARIANTS = ("full", "no-pick", "no-fold")
# the scan ablation's plain version is compared at this many steps at K=16384
PROBE_SCAN_COMPARE_TM = 4
# probe_alu is also held on a block of an odd element count, which leaves
# the resident grid's last pair one element
PROBE_ALU_RAGGED = (331, 257)
# probe_alu's targets: at RATE_R rounds this share of the issue limit of 64
# cells a clock an SM; at R rounds a device time within twice the bound
PROBE_ALU_RATE_SHARE = 0.9
PROBE_ALU_R_MS = 0.008


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def elapsed_ms(fn, device: torch.device, reps: int) -> float:
    """Median milliseconds of ``reps`` synchronized runs of ``fn``."""
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|; equal entries (including equal infinities) count 0."""
    a64, b64 = a.double(), b.double()
    diff = torch.where(a64 == b64, torch.zeros_like(a64), (a64 - b64).abs())
    return float(diff.max()) if diff.numel() else 0.0


def device_phase() -> torch.device:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    return torch.device("cuda", 0)


def build_phase() -> None:
    from flash_viterbi_tpu_torch.runtime import build

    secs = build.build()
    build.kernels()
    print(f"build: nvcc {secs:.1f} s", flush=True)
    reports = spills = 0
    with open(build.BUILD_LOG) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip().split("ptxas info    : ")[-1])
            if "spill stores" in line:
                reports += 1
                spills += "0 bytes spill stores, 0 bytes spill loads" not in line
    print(f"ptxas: {reports} kernels, {spills} with spills", flush=True)


def tables(hmm, pad_to: int, device):
    return hmm.log(device=device).padded(pad_to)


def phase_inputs(lh, y, device, seed: int):
    """The four kernels' inputs at the shapes the flash decode gives them:
    phase 1 (N=1 over T-1 steps) and phase 2 (N=16 lanes over the longest
    segment, with its ragged valid mask); lane start states drawn from
    ``seed`` stand in for the anchors."""
    from flash_viterbi_tpu_torch.algorithms.flash import (flash_midpoints,
                                                          segment_layout)

    T = len(y)
    emits = lh.logB.t()[torch.as_tensor(y, dtype=torch.int64, device=device)].contiguous()
    scan_in = (lh.logA, emits[1:].unsqueeze(1), (lh.logPi + emits[0])[None, :])
    mids = flash_midpoints(0, T - 1, SEGMENTS)
    starts, lens, Lmax = segment_layout(mids, T)
    rng = np.random.default_rng(seed)
    init = torch.as_tensor(rng.integers(0, lh.K, SEGMENTS), device=device)
    idx = torch.clamp(torch.as_tensor(starts, device=device)[:, None]
                      + torch.arange(Lmax, device=device)[None, :], max=T - 1)
    seg = emits[idx]
    d0 = (lh.logA[init] + seg[:, 0]).contiguous()
    deltas_in = (lh.logA, seg[:, 1:].transpose(0, 1).contiguous(), d0)
    valid = (torch.arange(1, Lmax, device=device)[:, None]
             <= torch.as_tensor(lens, device=device)[None, :] - 1)
    return scan_in, deltas_in, valid


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def work_scan(args, outs):
    """maxplus_scan / maxplus_scan_deltas: logA once, or once and then every
    step the part the card cannot hold on chip (``bounds.table_bytes``),
    every other input and output once; an add and a max per (step, lane,
    source, destination)."""
    Tm, N, K = args[1].shape
    return (table_bytes(args[0], Tm) + nbytes(*args[1:], *outs), 2 * Tm * N * K * K)


def work_emitgather(args, outs):
    """The gather scan: as the scan, with only the logBT rows its symbols
    name."""
    logA, _, ys, delta0 = args
    Tm, N = ys.shape
    K = logA.shape[0]
    rows = int(torch.unique(ys).numel())
    return (table_bytes(logA, Tm) + nbytes(ys, delta0, *outs) + rows * K * 4,
            2 * Tm * N * K * K)


def work_backtrack(args, outs):
    """The pointer walk: the 4-byte entries its paths follow (row t's entry
    of each lane whose state at t+1 is in [0, K): this run's data decides
    where a path leaves the table), the last states and the paths once.
    The whole table once, as the TPU kernel's cost estimate counts it
    (backtrack.py:135-137), is printed beside it as information."""
    ptrs, last = args
    later = outs[0][:, 1:]
    followed = int(((later >= 0) & (later < ptrs.shape[2])).sum())
    return followed * 4 + nbytes(last, *outs), 0


def work_walk(args, outs):
    """The argmax walk: per walked row one carry row, and the logAT rows of
    the states it walks from (each distinct row once, at its element size)."""
    deltas, logAT, last, valid = args
    Tm, N, K = deltas.shape
    v = torch.ones((Tm, N), dtype=torch.bool, device=deltas.device) if valid is None else valid
    walked = int(v.sum())
    rows = int(torch.unique(outs[0][:, 1:].t()[v]).numel())
    return ((walked * deltas.element_size() + rows * logAT.element_size()) * K
            + nbytes(last, valid, *outs), 2 * walked * K)


def work_beam(args, outs):
    """The beam scan: the distinct logA rows its beams fold (each once),
    the emission row of each real step, the small inputs and the outputs;
    an add and a compare per (step, slot, column) and a select of K."""
    logA, emits, vals0, states0, valid, prop = args
    Tm, N, K = emits.shape
    B = vals0.shape[1]
    v = torch.ones((Tm, N), dtype=torch.bool, device=emits.device) if valid is None else valid
    beams = torch.cat([states0[None], outs[0][:-1]])  # the beam each step folds
    rows = int(torch.unique(beams[v]).numel())
    steps = int(v.sum())
    return ((rows + steps) * K * 4 + nbytes(vals0, states0, valid, prop, *outs),
            steps * (2 * B * K + K))


def work_step_block(args, outs):
    """The step block: the carry, the column shard and both outputs once;
    an add and a max per (lane, source, destination)."""
    delta, logA_block = args
    return nbytes(*args, *outs), 2 * delta.shape[0] * logA_block.numel()


def work_fold(args, outs):
    """The fold: the planes, the pointer rows and the schedule in, the
    planes out, each once; no arithmetic (gathers and selects)."""
    return nbytes(*args, *outs), 0


WORK = {"maxplus_scan": work_scan, "maxplus_scan_deltas": work_scan,
        "maxplus_scan_emitgather": work_emitgather, "maxplus_step_block": work_step_block,
        "backtrack_batched": work_backtrack, "argmax_walk": work_walk, "beam_scan": work_beam,
        "fold_planes": work_fold, BF16_SCAN: work_scan, BF16_DELTAS: work_scan,
        BF16_WALK: work_walk}


def card():
    """The bounds' figures of card 0 (``flash_viterbi_tpu_torch.bench.bounds``):
    its SMs, maximum SM clock and on-chip bytes as it reports them, and the
    published 3.35 TB/s."""
    from flash_viterbi_tpu_torch.bench import bounds

    return bounds.card(torch.device("cuda", 0))


def table_bytes(logA: torch.Tensor, steps: int) -> int:
    """Bytes a scan must move of ``logA`` over ``steps`` steps on this card."""
    from flash_viterbi_tpu_torch.bench import bounds

    return bounds.table_bytes(nbytes(logA), steps, card())


def bound(moved: int, ops: int) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes at the published
    memory rate and the operations at the card's issue rate, 128 an SM a
    clock at its maximum SM clock (an add, a max or a compare is one; the
    published 67 TFLOP/s fp32 counts an FMA, which no kernel here does, as
    two)."""
    from flash_viterbi_tpu_torch.bench import bounds

    return bounds.bound(moved, ops, card())


def compare(name: str, kernel, plain, args, device, reps: int = 0) -> dict:
    """Run a kernel and its plain version on the same inputs; require
    bit-equal outputs; optionally time both and bound the kernel
    (:func:`bound`), its bytes and operations counted from these inputs."""
    got, want = kernel(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{name}: kernel differs from its plain version (max abs err {err})")
    rec = {"name": name, "max_abs_err": err}
    if reps:
        rec["ms"] = elapsed_ms(lambda: kernel(*args), device, reps)
        rec["plain_ms"] = elapsed_ms(lambda: plain(*args), device, max(1, reps // 3))
        moved, ops = WORK[name](args, got)
        bound_ms, bound_by = bound(moved, ops)
        rec.update(bound_ms=bound_ms, bound_by=bound_by, bytes=moved, operations=ops,
                   # no single PyTorch call computes a max-plus scan, a
                   # pointer walk, a beam scan, or a max with its lowest index
                   library_ms=None)
    return rec


def check_all(scan_in, deltas_in, valid, device, reps: int = 0) -> list[dict]:
    """All four kernels against their plain versions: the pointer scan and
    the backtrack on ``scan_in``, the deltas scan and the walk (with the
    ``valid`` mask, timed with a shared error word as a decode runs it) on
    ``deltas_in``."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops import maxplus as mp
    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    recs = [compare("maxplus_scan", k.maxplus_scan, km.maxplus_scan_plain,
                    scan_in, device, reps),
            compare("maxplus_scan_deltas", k.maxplus_scan_deltas,
                    km.maxplus_scan_deltas_plain, deltas_in, device, reps)]
    dfin, ptrs = k.maxplus_scan(*scan_in)
    last = mp.first_argmax(dfin, 1)[1]
    recs.append(compare("backtrack_batched", k.backtrack_batched,
                        kb.backtrack_batched_plain, (ptrs, last), device, reps))
    dfinN, deltas = k.maxplus_scan_deltas(*deltas_in)
    lastN = mp.first_argmax(dfinN, 1)[1]
    logAT = deltas_in[0].t().contiguous()
    recs.append(compare("argmax_walk", shared_word(k.argmax_walk, device),
                        kb.argmax_walk_plain, (deltas, logAT, lastN, valid), device, reps))
    return recs


def shared_word(kernel, device):
    """``kernel`` (the beam scan or the argmax walk) with one error word for
    every call, read once at the end of the kernel phase, as a decode runs
    them; a call's own word would add a host read to its time."""
    import functools

    from flash_viterbi_tpu_torch.ops.cuda.maxplus import error_word

    global SHARED_ERR
    if SHARED_ERR is None:
        SHARED_ERR = error_word(device)
    return functools.partial(kernel, err=SHARED_ERR)


def tie_fixture(device, K: int = 1000, N: int = 20, Tm: int = 21, seed: int = 5):
    """Integer-valued tables: exact fp32 ties everywhere.  K is not a
    multiple of the kernels' 32-column tile and N needs two lane groups."""
    rng = np.random.default_rng(seed)

    def put(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    logA = put(np.round(rng.standard_normal((K, K)) * 2) / 2)
    emits = put(np.round(rng.standard_normal((Tm, N, K))))
    delta0 = put(np.round(rng.standard_normal((N, K))))
    valid = torch.as_tensor(rng.random((Tm, N)) < 0.8, device=device)
    return (logA, emits, delta0), valid


def hbm_read_gbps(device) -> float:
    """Measured read bandwidth: a max-reduction over 2 GiB of fp32."""
    x = torch.empty(2**29, dtype=torch.float32, device=device).uniform_()
    ms = elapsed_ms(lambda: torch.amax(x), device, 10)
    return x.numel() * 4 / (ms * 1e-3) / 1e9


def eg_inputs(lh, y, device):
    """The emission-gather scan's inputs for one chunk over steps 1..T-1
    of ``y`` (N=1): logA, logBT, the (T-1, 1) int32 symbols, and the
    step-0 carry."""
    logBT = lh.logB.t().contiguous()
    yd = torch.as_tensor(y, dtype=torch.int32, device=device)
    delta0 = (lh.logPi + logBT[yd[0].long()])[None, :].contiguous()
    return lh.logA, logBT, yd[1:, None].contiguous(), delta0


def tie_eg_inputs(ties, device, M: int = 7, seed: int = 6):
    """The tie fixture's logA and carries with an integer-valued (M, K)
    logBT and (T', N) symbols drawn from ``seed``."""
    logA, emits, delta0 = ties
    Tm, N, K = emits.shape
    rng = np.random.default_rng(seed)
    logBT = torch.as_tensor(np.round(rng.standard_normal((M, K))).astype(np.float32),
                            device=device)
    ys = torch.as_tensor(rng.integers(0, M, (Tm, N)).astype(np.int32), device=device)
    return logA, logBT, ys, delta0


def batch_seqs() -> np.ndarray:
    """The batch phase's (max(BATCHES), T) sequences,
    ``observations(T, M, seed=s)`` for s = 1, 2, ..."""
    from flash_viterbi_tpu_torch.models.generate import observations

    return np.stack([observations(HEADLINE["T"], HEADLINE["M"], seed=s)
                     for s in range(1, max(BATCHES) + 1)])


def batch_inputs(lh, seqs, device):
    """The four kernels' inputs at the shapes ``fused_decode_batch`` gives
    them for ``seqs``: one lane per sequence over T-1 steps, every row of
    the walk valid."""
    ys = torch.as_tensor(seqs.astype(np.int64), device=device)
    emits = lh.logB.t()[ys.t()].contiguous()
    scan_in = (lh.logA, emits[1:], (lh.logPi[None, :] + emits[0]).contiguous())
    return scan_in, scan_in, None


def beam_inputs(lh, y, device, B: int = BEAM_WIDTH, P: int = BEAM_SEGMENTS - 1):
    """The beam scan's inputs at flash_bs's phase-1 shape: N=1 over T-1
    steps from the top B of the first scores, with P anchor planes."""
    from flash_viterbi_tpu_torch.algorithms.flash import flash_midpoints, prop_schedule
    from flash_viterbi_tpu_torch.ops.beam import beam_topk

    T = len(y)
    emits = lh.logB.t()[torch.as_tensor(y, dtype=torch.int64, device=device)].contiguous()
    vals0, states0 = beam_topk((lh.logPi + emits[0])[None, :], B)
    prop = torch.as_tensor(prop_schedule(flash_midpoints(0, T - 1, P + 1), T), device=device)
    return lh.logA, emits[1:].unsqueeze(1), vals0, states0, None, prop


def beam_segment_inputs(lh, y, device, seed: int, B: int = BEAM_WIDTH,
                        segments: int = BEAM_SEGMENTS):
    """The beam scan's inputs at flash_bs's segment shape: one lane per
    segment over Lmax-1 steps with the ragged valid mask; start rows from
    logA at states drawn from ``seed`` stand in for the anchors."""
    from flash_viterbi_tpu_torch.algorithms.flash import flash_midpoints, segment_layout
    from flash_viterbi_tpu_torch.ops.beam import beam_topk

    T = len(y)
    emits = lh.logB.t()[torch.as_tensor(y, dtype=torch.int64, device=device)].contiguous()
    starts, lens, Lmax = segment_layout(flash_midpoints(0, T - 1, segments), T)
    init = torch.as_tensor(np.random.default_rng(seed).integers(0, lh.K, segments),
                           device=device)
    idx = torch.clamp(torch.as_tensor(starts, device=device)[:, None]
                      + torch.arange(Lmax, device=device)[None, :], max=T - 1)
    seg = emits[idx]
    vals0, states0 = beam_topk(lh.logA[init] + seg[:, 0], B)
    valid = (torch.arange(1, Lmax, device=device)[:, None]
             <= torch.as_tensor(lens, device=device)[None, :] - 1)
    return lh.logA, seg[:, 1:].transpose(0, 1).contiguous(), vals0, states0, valid, None


def beam_tie_inputs(ties, valid, device, B: int = 128, P: int = 3, seed: int = 7):
    """The tie fixture's tables made sparse (0.4% of the edges) and its
    start rows cut to ~0.5% finite scores, so the early beams hold fewer
    than B finite scores; with its valid mask and P planes."""
    from flash_viterbi_tpu_torch.algorithms.flash import flash_midpoints, prop_schedule
    from flash_viterbi_tpu_torch.ops.beam import beam_topk

    logA, emits, delta0 = ties
    Tm, K = emits.shape[0], logA.shape[0]
    rng = np.random.default_rng(seed)
    neg = torch.tensor(float("-inf"), device=device)
    sparse = torch.where(torch.as_tensor(rng.random((K, K)) < 0.004, device=device),
                         logA, neg)
    start = torch.where(torch.as_tensor(rng.random(tuple(delta0.shape)) < 0.005,
                                        device=device), delta0, neg)
    vals0, states0 = beam_topk(start, B)
    prop = torch.as_tensor(prop_schedule(flash_midpoints(0, Tm, P + 1), Tm + 1),
                           device=device)
    return sparse, emits, vals0, states0, valid, prop


def beam_select_checks(device, head, y) -> list[dict]:
    """The beam scan's select and its plans against the plain beam scan:
    a one-step scan over all-zero transitions from an all-zero beam selects
    the top B of its emission row (ties, -inf and -0.0) at B = 1, 128 and
    K=1000, also held to ``beam_topk`` on the card and on the CPU; the
    phase-1 shape under clusters forced to C = 1, 2 and 16, and with the
    state squeezed out of shared memory into the global scratch (a ring of
    one group, refilled eight times a step); Kp=17000 (values in halves:
    ties everywhere) at B=64, with its own plan and with C=2 (chunks of 2048
    columns), and the full beam B=Kp, whose state takes the scratch.
    Returns the comparisons' records."""
    import functools

    from flash_viterbi_tpu_torch.ops import beam as bp
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.beam import beam_topk
    from flash_viterbi_tpu_torch.ops.cuda import beam as kb
    from flash_viterbi_tpu_torch.ops.cuda.maxplus import sm_count

    def check(args, plan=None) -> dict:
        kernel = k.beam_scan if plan is None else functools.partial(k.beam_scan, plan=plan)
        return compare("beam_scan", kernel, bp.beam_scan_plain, args, device)

    t0 = time.perf_counter()
    recs = []
    sms = sm_count(device)
    K = 1000
    row = np.random.default_rng(11).choice(
        np.array([1.0, 0.5, 0.0, -0.0, -2.0, -np.inf], np.float32), K)
    row_d = torch.as_tensor(row, device=device)
    zerosA = torch.zeros((K, K), device=device)
    for B in (1, 128, K):
        args = (zerosA, row_d[None, None, :], torch.zeros((1, B), device=device),
                torch.zeros((1, B), dtype=torch.int32, device=device), None, None)
        recs.append(check(args))
        hist = k.beam_scan(*args[:4])[0]
        card = beam_topk(row_d[None], B)[1]
        cpu = beam_topk(torch.as_tensor(row)[None], B)[1]
        require(torch.equal(hist[0], card) and torch.equal(card.cpu(), cpu),
                f"beam_topk on the card differs from the kernel's select at B={B}")
    phase1 = beam_inputs(head, y, device)
    P = phase1[5].shape[1]
    for C in (1, 2, 16):
        recs.append(check(phase1, kb.beam_plan(head.Kp, BEAM_WIDTH, 1, sms, P, C=C)))
    roomy = kb.beam_plan(head.Kp, BEAM_WIDTH, 1, sms, P, C=16)
    squeezed = kb.beam_plan(head.Kp, BEAM_WIDTH, 1, sms, P, C=16,
                            smem_bytes=kb.STATIC_SMEM + roomy.rg * roomy.cw * 4 + 1024)
    require(not squeezed.state_smem and squeezed.g == 1, f"not a squeezed plan: {squeezed}")
    recs.append(check(phase1, squeezed))
    beam = shared_word(k.beam_scan, device)
    by_c, by_b = {}, {}
    for C in (1, 2, 4, 8, 16):
        plan = kb.beam_plan(head.Kp, BEAM_WIDTH, 1, sms, P, C=C)
        by_c[C] = elapsed_ms(lambda: beam(*phase1, plan=plan), device, 7)
    for b in (1, 8, 32, 64):
        inputs = beam_inputs(head, y, device, B=b)
        by_b[b] = elapsed_ms(lambda: beam(*inputs), device, 7)
    print(f"beam_scan at the phase-1 shape (T'={len(y) - 1}), ms by cluster size at B=64: "
          f"{by_c}; by B at the card's plan: {by_b}; the squeezed plan (state in the scratch, "
          f"a ring of one group): {elapsed_ms(lambda: beam(*phase1, plan=squeezed), device, 7):.4f}",
          flush=True)
    big, B = BEAM_LARGE["K"], BEAM_WIDTH
    g = torch.Generator(device=device).manual_seed(12)
    logA = torch.round(torch.randn((big, big), generator=g, device=device) * 2) / 2
    emits = torch.round(torch.randn((4, 1, big), generator=g, device=device))
    start = torch.round(torch.randn((1, big), generator=g, device=device))
    vals0, states0 = beam_topk(start, B)
    args = (logA, emits, vals0, states0, None, None)
    plan = kb.beam_plan(big, B, 1, sms)
    chunked = kb.beam_plan(big, B, 1, sms, C=2)
    require(plan.state_smem and -(-chunked.width // chunked.cw) > 1,
            f"Kp={big}: plans {plan} and {chunked}")
    recs += [check(args), check(args, chunked)]
    ms = elapsed_ms(lambda: shared_word(k.beam_scan, device)(*args[:4]), device, 5)
    full = kb.beam_plan(big, big, 1, sms)
    require(not full.state_smem, f"Kp={big}, B={big}: the state fits shared memory: {full}")
    recs.append(check((logA, emits[:2], *beam_topk(start, big), None, None)))
    print(f"beam select: the zero-table select equals the plain scan and beam_topk at B = 1, "
          f"128, {K}; the phase-1 shape under C = 1, 2, 16 and with the state in the global "
          f"scratch; Kp={big}, B={B}, T'=4 under C={plan.C} ({ms:.3f} ms, "
          f"{ms / 4 * 1e3:.1f} us a step) and C=2 ({-(-chunked.width // chunked.cw)} chunks a "
          f"CTA); B={big}, T'=2 with its state in the scratch: all equal the plain beam scan; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return recs


def fold_inputs(lh, y, device):
    """fold_planes' inputs where lean mode's phase 1 gives them at the
    headline (a chunk of LEAN_CHUNK pointer rows of the N=1 scan from step
    c0 + 1, one row a step for all SEGMENTS - 1 anchor planes, the
    schedule flipping from record to propagate inside it), at its largest
    round's shape at T=16384 (118 lanes of t2 planes, a row each), and where
    ``sieve_mp``'s top level gives them (the rows after the midpoint of the
    N=1 scan over the whole request, FOLD_TOP_ROWS of them, folded into one
    identity plane, every row propagating)."""
    from flash_viterbi_tpu_torch.algorithms.flash import (LEAN_CHUNK, flash_midpoints,
                                                          prop_schedule)
    from flash_viterbi_tpu_torch.ops import cuda as k

    T = len(y)
    c0 = 96
    emits = lh.logB.t()[torch.as_tensor(y, dtype=torch.int64, device=device)].contiguous()
    d0 = (lh.logPi + emits[c0])[None, :]
    _, ptrs = k.maxplus_scan(lh.logA, emits[c0 + 1:c0 + 1 + LEAN_CHUNK].unsqueeze(1), d0)
    mids = flash_midpoints(0, T - 1, SEGMENTS)
    prop = torch.as_tensor(prop_schedule(mids, T, c0 + 1, c0 + 1 + LEAN_CHUNK), device=device)
    rng = np.random.default_rng(11)
    planes = torch.as_tensor(rng.integers(0, lh.Kp, (SEGMENTS - 1, lh.Kp)), dtype=torch.int32,
                             device=device)
    S = 118
    t2 = torch.as_tensor(rng.integers(0, lh.Kp, (S, lh.Kp)), dtype=torch.int32, device=device)
    rows = torch.as_tensor(rng.integers(0, lh.Kp, (LEAN_CHUNK, S, lh.Kp)), dtype=torch.int32,
                           device=device)
    rprop = torch.as_tensor(rng.random((LEAN_CHUNK, S)) < 0.5, device=device)
    _, top = k.maxplus_scan(lh.logA, emits[1:].unsqueeze(1), (lh.logPi + emits[0])[None, :])
    top = top[-FOLD_TOP_ROWS:].contiguous()
    iota = torch.arange(lh.Kp, dtype=torch.int32, device=device)[None, :].contiguous()
    ones = torch.ones((FOLD_TOP_ROWS, 1), dtype=torch.bool, device=device)
    return (planes, ptrs, prop), (t2, rows, rprop), (iota, top, ones)


def fold_minus_one(planes, rows, prop) -> np.ndarray:
    """The fold one row at a time in numpy with the card's rule: a pointer
    outside [0, K) gives -1, and -1 is carried on."""
    out, rows, prop = (x.cpu().numpy() for x in (planes, rows, prop))
    K = out.shape[1]
    for t in range(rows.shape[0]):
        row = np.broadcast_to(rows[t], out.shape)
        ok = (row >= 0) & (row < K)
        moved = np.where(ok, np.take_along_axis(out, np.where(ok, row, 0), 1), -1)
        out = np.where(prop[t][:, None], moved, row)
    return out


def fold_checks(phase1_in, round_in, top_in, device) -> list[dict]:
    """fold_planes against its plain version and the numpy fold with the
    -1 rule beyond the headline shape: the round shape, sieve_mp's top level
    (one plane, FOLD_TOP_ROWS rows), one step, every plane propagating or
    recording, the phase-1 chunk under clusters forced to G = 1, 2, 8 and
    16, records that straddle the groups' edges, out-of-range pointers
    (against the numpy fold only), K=30000, whose maps leave shared memory
    (the global scratch), under its own plan and a cluster of 4, and the
    phase-1 chunk under a plan squeezed into the scratch.  Each call makes
    one launch."""
    import functools

    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda import fold as kf
    from flash_viterbi_tpu_torch.ops.cuda.maxplus import sm_count

    planes, ptrs, prop = phase1_in
    P, Kp = planes.shape
    c = ptrs.shape[0]
    sms = sm_count(device)
    rng = np.random.default_rng(12)

    def draw(Pn, cn, K, Rn=1):
        return (torch.as_tensor(rng.integers(0, K, (Pn, K)), dtype=torch.int32, device=device),
                torch.as_tensor(rng.integers(0, K, (cn, Rn, K)), dtype=torch.int32,
                                device=device),
                torch.as_tensor(rng.random((cn, Pn)) < 0.7, device=device))

    def hold(args, plan=None, plain=True) -> dict:
        kernel = functools.partial(k.fold_planes, plan=plan)
        before = k.fold_planes.launches
        want = fold_minus_one(*args)
        if plain:
            rec = compare("fold_planes", kernel, kf.fold_planes_plain, args, device)
            got = kernel(*args)
        else:
            got = kernel(*args)
            rec = {"name": "fold_planes",
                   "max_abs_err": max_abs_err(got.cpu(), torch.as_tensor(want))}
        require(np.array_equal(got.cpu().numpy(), want),
                f"fold_planes differs from the numpy fold (plan {plan})")
        require(k.fold_planes.launches - before == (2 if plain else 1),
                f"fold_planes made {k.fold_planes.launches - before} launches for "
                f"{2 if plain else 1} calls")
        return rec

    recs = [hold(round_in), hold(top_in), hold((planes, ptrs[:1], prop[:1])),
            hold((planes, ptrs, torch.ones_like(prop))),
            hold((planes, ptrs, torch.zeros_like(prop)))]
    for G in FOLD_FORCED_G:
        recs.append(hold(phase1_in, kf.fold_plan(P, c, 1, Kp, sms, G=G)))
    # one record per plane: on a group's first row, the row before it, after
    # it, on the last row; one plane every 5 rows across every edge
    straddle = prop.clone()
    straddle[:] = True
    edges = kf.fold_plan(P, c, 1, Kp, sms, G=8).row_edges
    for p, t in enumerate((edges[4], edges[4] - 1, edges[4] + 1, c - 1, 0, edges[1])):
        straddle[t, p] = False
    straddle[:, 7] = torch.arange(c, device=device) % 5 != 0
    for G in (8, 16):
        recs.append(hold((planes, ptrs, straddle), kf.fold_plan(P, c, 1, Kp, sms, G=G)))
    # out-of-range pointers: -1, -7, K and K + 5 planted in every row
    bad = ptrs.clone()
    at = torch.as_tensor(rng.integers(0, Kp, (c, 3)), device=device)
    vals = torch.as_tensor(rng.choice([-1, -7, Kp, Kp + 5], (c, 3)), dtype=torch.int32,
                           device=device)
    bad[:, 0].scatter_(1, at, vals)
    for G in (1, 8):
        recs.append(hold((planes, bad, prop), kf.fold_plan(P, c, 1, Kp, sms, G=G),
                         plain=False))
    Kbig = 30000
    big = draw(3, 16, Kbig)
    plan_big = kf.fold_plan(3, 16, 1, Kbig, sms)
    require(not plan_big.maps_smem and kf.fold_plan(P, c, 1, Kp, sms).maps_smem,
            f"fold_planes: K={Kbig} should take the global scratch, K={Kp} shared memory")
    squeezed = kf.fold_plan(P, c, 1, Kp, sms, smem_bytes=4 * Kp, G=8)
    recs += [hold(big), hold(big, kf.fold_plan(3, 16, 1, Kbig, sms, G=4)),
             hold(draw(3, 5, Kbig)), hold(phase1_in, squeezed)]
    return recs


def fold_times(phase1_in, round_in, top_in, device) -> None:
    """fold_planes at its three decode shapes (lean phase 1's chunk, the
    round shape, sieve_mp's top level): the median of 9 CUDA-event runs
    around one call (the host's launch included), the device time a call
    back to back (queued) and with L2 flushed, each beside its bound by
    bytes, with the cluster size of its plan."""
    import functools

    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda import fold as kf
    from flash_viterbi_tpu_torch.ops.cuda.maxplus import sm_count

    fold = shared_word(k.fold_planes, device)
    for label, args in (("phase-1 chunk", phase1_in), ("round shape", round_in),
                        ("sieve_mp top level", top_in)):
        (P, K), (c, R, _) = args[0].shape, args[1].shape
        plan = kf.fold_plan(P, c, R, K, sm_count(device))
        timed = elapsed_ms(lambda: fold(*args), device, 9)
        queued = queued_ms(lambda: fold(*args), device)
        cold = cold_ms(lambda: fold(*args), device, 9)
        moved = WORK["fold_planes"](args, (args[0],))[0]
        print(f"fold_planes at the {label} (P={P}, c={c}, R={R}, K={K}; G={plan.G}, ring "
              f"{plan.ring}, maps in {'shared memory' if plan.maps_smem else 'the scratch'}): "
              f"{timed:.4f} ms a timed call, {queued:.4f} ms of device time back to back, "
              f"{cold:.4f} ms with L2 flushed; bound {bound(moved, 0)[0] * 1e3:.3f} us by bytes "
              f"({moved} bytes), {-(-c // plan.G) + (plan.G - 1).bit_length()} dependent "
              f"passes", flush=True)
    # one dependent pass (a gather of K entries and a barrier): the slope of
    # one plane's fold on one CTA from 32 to 128 rows
    iota, top, ones = top_in
    K, short = iota.shape[1], FOLD_TOP_ROWS // 4
    one = {c: queued_ms(functools.partial(fold, iota, top[:c], ones[:c],
                                          plan=kf.fold_plan(1, c, 1, K, sm_count(device), G=1)),
                        device) for c in (short, FOLD_TOP_ROWS)}
    print(f"fold_planes: one dependent pass at K={K} (one CTA, {short} to {FOLD_TOP_ROWS} "
          f"rows) {(one[FOLD_TOP_ROWS] - one[short]) / (FOLD_TOP_ROWS - short) * 1e3:.4f} us",
          flush=True)


def walk_checks(head, y, device) -> tuple[list[dict], dict]:
    """argmax_walk against its plain version at the recompute batch's
    shapes (N = 16 and 64 headline sequences, T'=255, timed), and with out
    of range last states (-1 and K + 5), whose lanes the kernel writes as
    -1 while the others equal the plain walk.  Returns the records and the
    batch shapes' times."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops import maxplus as mp
    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb

    recs, times = [], {}
    logAT = head.logA.t().contiguous()
    seqs = batch_seqs()
    for N in (16, 64):
        scan_in = batch_inputs(head, seqs[:N], device)[0]
        dfin, deltas = k.maxplus_scan_deltas(*scan_in)
        last = mp.first_argmax(dfin, 1)[1]
        rec = compare("argmax_walk", shared_word(k.argmax_walk, device), kb.argmax_walk_plain,
                      (deltas, logAT, last, None), device, reps=9)
        times[N] = rec["ms"]
        recs.append(rec)
    _, deltas_in, valid = phase_inputs(head, y, device, seed=4)
    dfin, deltas = k.maxplus_scan_deltas(*deltas_in)
    last = mp.first_argmax(dfin, 1)[1].clone()
    last[1], last[2] = head.Kp + 5, -1
    got = k.argmax_walk(deltas, logAT, last, valid)
    keep = torch.tensor([n for n in range(len(last)) if n not in (1, 2)], device=device)
    want = kb.argmax_walk_plain(deltas[:, keep].contiguous(), logAT, last[keep], valid[:, keep])
    require(bool((got[1:3] == -1).all()) and torch.equal(got[keep], want),
            "argmax_walk with out-of-range last states differs")
    print(f"argmax_walk at N=16 and 64, T'=255: {times[16]:.4f} / {times[64]:.4f} ms "
          f"({times[16] / 255 * 1e3:.2f} / {times[64] / 255 * 1e3:.2f} us a step); out-of-range "
          f"last states give -1 lanes, the others equal the plain walk", flush=True)
    return recs, times


def pointer_table(Tm: int, N: int, K: int, device, seed: int):
    """(T', N, K) int32 pointers in [0, K) and (N,) last states in [0, K),
    drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    ptrs = torch.randint(0, K, (Tm, N, K), generator=g, device=device, dtype=torch.int32)
    last = torch.randint(0, K, (N,), generator=g, device=device, dtype=torch.int32)
    return ptrs, last


def plant(ptrs, last):
    """Put -5, -1, K and K+3 (lane by lane, in turn) on each lane's walk at
    a row of its own, and end lanes 1 and 2 (where there are 3 lanes) in K+7
    and -2: the table's entries are read as the TPU kernel reads them (-1
    below -1; K and above as they are, then -1)."""
    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb

    Tm, N, K = ptrs.shape
    path = kb.backtrack_batched_plain(ptrs, last)
    lanes = torch.arange(N, device=ptrs.device)
    t_hit = (lanes * 7919 + Tm // 3) % Tm
    values = torch.tensor((-5, -1, K, K + 3), dtype=torch.int32, device=ptrs.device)
    ptrs[t_hit, lanes, path[lanes, t_hit + 1].long()] = values[lanes % 4]
    if N >= 3:
        last[1], last[2] = K + 7, -2
    return ptrs, last


def backtrack_checks(device) -> list[dict]:
    """backtrack_batched against its plain version, bit for bit, one launch
    a call: at BACKTRACK_SHAPES under the card's plan (timed back to back
    against the serial plan, the parent's design, on the same inputs); with
    planted entries and out-of-range last states (BACKTRACK_PLANTED) under
    the card's plan, a chunk a row, chunks of 5 rows in 8 slices and the
    serial plan; on the GRID_K x GRID_N grid at T' = 1, L-1, L, L+1 and 255
    (L the card's chunk at T'=255, else 16) under the card's plan and under
    a chunked plan of L rows (fewer where T' <= L).  Returns the
    comparisons' records."""
    import functools

    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    t0 = time.perf_counter()
    sms = km.sm_count(device)
    recs, plans = [], 0

    def hold(ptrs, last, plan=None) -> None:
        nonlocal plans
        walk = functools.partial(k.backtrack_batched, plan=plan)
        before = k.backtrack_batched.launches
        recs.append(compare("backtrack_batched", walk, kb.backtrack_batched_plain,
                            (ptrs, last), device))
        require(k.backtrack_batched.launches - before == 1,
                f"backtrack_batched made {k.backtrack_batched.launches - before} launches "
                f"at {tuple(ptrs.shape)} under {plan}")
        plans += 1

    for i, (Tm, N, K) in enumerate(BACKTRACK_SHAPES):
        ptrs, last = pointer_table(Tm, N, K, device, seed=40 + i)
        hold(ptrs, last)
        plan, serial = kb.backtrack_plan(Tm, N, K, sms), kb.serial_plan(Tm, N)
        walk = k.backtrack_batched
        ms = queued_ms(lambda: walk(ptrs, last), device)
        serial_ms = queued_ms(lambda: walk(ptrs, last, plan=serial), device)
        moved, _ = work_backtrack((ptrs, last), (walk(ptrs, last),))
        print(f"backtrack_batched at (T', N, K) = ({Tm}, {N}, {K}): {ms:.4f} ms of device "
              f"time back to back under G={plan.G}, L={plan.L}, S={plan.S}, "
              f"blocks={plan.blocks}, E={plan.E}; the serial walk {serial_ms:.4f} ms "
              f"({serial_ms / ms:.2f}x); bound {bound(moved, 0)[0]:.7f} ms by bytes (the "
              f"entries the paths follow); the table once {bound(nbytes(ptrs), 0)[0]:.5f} ms "
              f"(information)", flush=True)
        del ptrs, last
    for i, (Tm, N, K) in enumerate(BACKTRACK_PLANTED):
        ptrs, last = plant(*pointer_table(Tm, N, K, device, seed=60 + i))
        S = -(-K // (kb.THREADS * kb.E_MAX))
        for plan in (None, kb.backtrack_plan(Tm, N, K, sms, L=1, S=S),
                     kb.backtrack_plan(Tm, N, K, sms, L=5, S=8 * S), kb.serial_plan(Tm, N)):
            hold(ptrs, last, plan)
        del ptrs, last
    for K in GRID_K:
        for N in GRID_N:
            top = kb.backtrack_plan(255, N, K, sms)
            L = 16 if top.serial else top.L
            S = max(top.S, -(-K // (kb.THREADS * kb.E_MAX)))  # E_MAX entries a thread
            for Tm in sorted({*BACKTRACK_GRID_TM, L - 1, L, L + 1} - {0}):
                ptrs, last = pointer_table(Tm, N, K, device, seed=K + N + Tm)
                hold(ptrs, last)
                if Tm >= 2:
                    hold(ptrs, last, kb.backtrack_plan(Tm, N, K, sms, L=min(L, Tm - 1), S=S))
                del ptrs, last
        torch.cuda.empty_cache()
    print(f"backtrack_batched: bit-exact under {plans} plans and fixtures, one launch each "
          f"(shapes {BACKTRACK_SHAPES}; planted -5 / -1 / K / K+3 entries and last states "
          f"K+7, -2 at {BACKTRACK_PLANTED}; the grid K = {GRID_K} x N = {GRID_N} at T' = 1, "
          f"L-1, L, L+1, 255); {time.perf_counter() - t0:.1f} s", flush=True)
    return recs


def chase_latency_us(device) -> float:
    """The card's dependent-load latency: ``probes/copy.py:probe_chase_rows``
    (one thread, each load's address from the previous load: the serial
    pointer walk, kept as a probe of its own since backtrack_batched's
    chunked plans no longer chase) through a table of random pointers of
    60 MiB, the size of the headline's logA, at K=3968; held to its plain
    version; microseconds a load, the median of 5 runs."""
    from flash_viterbi_tpu_torch.probes import copy as pc

    K = 3968
    Tm = 60 * 2**20 // (K * 4)
    g = torch.Generator(device=device).manual_seed(21)
    ptrs = torch.randint(0, K, (Tm, 1, K), generator=g, device=device, dtype=torch.int32)
    last = torch.zeros(1, dtype=torch.int32, device=device)
    require(torch.equal(pc.probe_chase_rows(ptrs, last).cpu(),
                        pc.probe_chase_rows_plain(ptrs.cpu(), last.cpu())),
            "probe_chase_rows differs from its plain version")
    us = elapsed_ms(lambda: pc.probe_chase_rows(ptrs, last), device, 5) / Tm * 1e3
    print(f"pointer chase (probe_chase_rows): {us:.4f} us a dependent load ({Tm} loads "
          f"through {Tm * K * 4} bytes; through the serial backtrack_batched that chased it "
          f"before, PERF.md's row 7, 0.1971 us)", flush=True)
    return us


def step_block_inputs(lh, y, device):
    """maxplus_step_block's inputs on the headline tables at the sharded
    decode's shapes: the (1, 1, 1) mesh's boundary step (the N=1 first
    carry against the whole table) and 16 phase-2 lanes (phase_inputs'
    carries) against the first of 4 state ranks' column shards."""
    scan_in, deltas_in, _ = phase_inputs(lh, y, device, seed=3)
    return ((scan_in[2], lh.logA),
            (deltas_in[2], lh.logA[:, :lh.Kp // 4].contiguous()))


def step_block_shard_inputs(lh, y, device):
    """maxplus_step_block's inputs at STEP_SHARD_SHAPES on the headline
    tables: phase_inputs' carries (the N=1 first carry, the first N of the
    16 phase-2 lanes) against the first of 2 state ranks' column shards."""
    scan_in, deltas_in, _ = phase_inputs(lh, y, device, seed=3)
    return [((scan_in[2] if N == 1 else deltas_in[2][:N].contiguous()),
             lh.logA[:, :Kd].contiguous()) for N, Kd in STEP_SHARD_SHAPES]


def cold_ms(fn, device, reps: int) -> float:
    """Median milliseconds of ``reps`` runs of ``fn``, each after writing
    128 MiB (more than the 50 MB L2) so that it finds its inputs in device
    memory; all of them queued behind a ~20 ms sleep of the card, so the
    events time the device, not the host's launch."""
    flush = torch.empty(32 * 2**20, device=device)
    fn()
    torch.cuda.synchronize(device)
    torch.cuda._sleep(40_000_000)
    events = []
    for _ in range(reps):
        flush.fill_(0.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(device)
    return statistics.median(start.elapsed_time(end) for start, end in events)


def step_block_config5_inputs(device, seed: int = 5):
    """One carry against config-5's K on one of 4 state ranks: a (16384,
    4096) block, 11.2% of it finite (the generator's edge density), drawn
    on the card from ``seed``."""
    K, Kd = CONFIG5["K"], CONFIG5["K"] // CONFIG5_MESH[2]
    g = torch.Generator(device=device).manual_seed(seed)
    block = torch.randn((K, Kd), generator=g, device=device)
    keep = torch.rand((K, Kd), generator=g, device=device) < CONFIG5["prob"]
    block = torch.where(keep, block, torch.tensor(float("-inf"), device=device))
    return torch.randn((1, K), generator=g, device=device), block


def step_block_tie_inputs(device, N: int = 20, Ks: int = 1000, Kd: int = 250,
                          seed: int = 8):
    """Integer-valued carries and block (exact ties everywhere); source row
    17 repeats row 3 in both; source row 9 and column 5 are all -inf; Kd is
    not a multiple of the 32-column tile and N needs two lane groups."""
    rng = np.random.default_rng(seed)
    block = np.round(rng.standard_normal((Ks, Kd)) * 2) / 2
    delta = np.round(rng.standard_normal((N, Ks)))
    block[17], delta[:, 17] = block[3], delta[:, 3]
    block[9], block[:, 5] = -np.inf, -np.inf
    return tuple(torch.as_tensor(x.astype(np.float32), device=device) for x in (delta, block))


def grid_inputs(K: int, N: int, Tm: int, device, seed: int, M: int = 50):
    """The parity grid's inputs, drawn on the card from ``seed``: logA,
    emits, delta0 and an (M, K) logBT in halves (ties everywhere), source
    row K // 3 and destination column K // 5 all -inf; (T', N) symbols."""
    g = torch.Generator(device=device).manual_seed(seed)

    def halves(*shape):
        return torch.round(torch.randn(shape, generator=g, device=device) * 2) / 2

    logA = halves(K, K)
    logA[K // 3] = float("-inf")
    logA[:, K // 5] = float("-inf")
    ys = torch.randint(0, M, (Tm, N), generator=g, device=device, dtype=torch.int32)
    return logA, halves(Tm, N, K), halves(N, K), halves(M, K), ys


def scan_grid_checks(device) -> list[dict]:
    """The three scans against their plain versions at every (K, N) of
    GRID_K x GRID_N; returns the comparisons' records."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    t0 = time.perf_counter()
    recs = []
    for K in GRID_K:
        for N in GRID_N:
            Tm = GRID_TM_LARGE if K > 4096 else GRID_TM
            logA, emits, delta0, logBT, ys = grid_inputs(K, N, Tm, device, seed=K + N)
            recs += [compare("maxplus_scan", k.maxplus_scan, km.maxplus_scan_plain,
                             (logA, emits, delta0), device),
                     compare("maxplus_scan_deltas", k.maxplus_scan_deltas,
                             km.maxplus_scan_deltas_plain, (logA, emits, delta0), device),
                     compare("maxplus_scan_emitgather", k.maxplus_scan_emitgather,
                             km.maxplus_scan_emitgather_plain, (logA, logBT, ys, delta0),
                             device)]
            del logA, emits, delta0, logBT, ys
        torch.cuda.empty_cache()
    print(f"scan parity grid: maxplus_scan, maxplus_scan_deltas and maxplus_scan_emitgather "
          f"bit-exact at K = {GRID_K} x N = {GRID_N} (T' = {GRID_TM}, {GRID_TM_LARGE} at "
          f"K > 4096); {time.perf_counter() - t0:.1f} s", flush=True)
    return recs


def looped_plan_checks(device) -> list[dict]:
    """The three scans against their plain versions under plans made for
    fewer SMs than K's column groups need (one range of every row, each
    block walking several tiles a step, as above K=67584 at 16 lanes), in
    both combines: 16 and 20 lanes on 4 SMs, one lane on 1 SM."""
    import functools

    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    t0 = time.perf_counter()
    recs = []
    for K, N, sms in LOOPED_PLANS:
        logA, emits, delta0, logBT, ys = grid_inputs(K, N, GRID_TM, device, seed=K + sms)
        for two_phase in (False, True):
            plan = km.scan_plan(K, N, sms, two_phase=two_phase)
            require(plan.tiles > plan.blocks == sms, f"plan {plan} walks one tile a block")
            recs += [compare("maxplus_scan", functools.partial(k.maxplus_scan, plan=plan),
                             km.maxplus_scan_plain, (logA, emits, delta0), device),
                     compare("maxplus_scan_deltas",
                             functools.partial(k.maxplus_scan_deltas, plan=plan),
                             km.maxplus_scan_deltas_plain, (logA, emits, delta0), device),
                     compare("maxplus_scan_emitgather",
                             functools.partial(k.maxplus_scan_emitgather, plan=plan),
                             km.maxplus_scan_emitgather_plain, (logA, logBT, ys, delta0),
                             device)]
    print(f"scans with several tiles a block (K, N, SMs) = {LOOPED_PLANS}, both combines: "
          f"bit-exact; {time.perf_counter() - t0:.1f} s", flush=True)
    return recs


def combine_turns(device) -> None:
    """Both ways of combining partials, in turns (on read, two-phase,
    two-phase, on read), for both scan forms at every lane count and K in
    COMBINE_SHAPES; the plan's default is marked."""
    import functools

    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    sms = km.sm_count(device)
    for K, N in COMBINE_SHAPES:
        Tm = 64 if K <= 4096 else 8
        logA, emits, delta0, _, _ = grid_inputs(K, N, Tm, device, seed=K * N)
        for name, fn in (("maxplus_scan", k.maxplus_scan),
                         ("maxplus_scan_deltas", k.maxplus_scan_deltas)):
            times = {False: [], True: []}
            for two_phase in (False, True, True, False):
                run = functools.partial(fn, logA, emits, delta0,
                                        plan=km.scan_plan(K, N, sms, two_phase=two_phase))
                run()
                times[two_phase].append(elapsed_ms(run, device, 5))
            on_read, two = (statistics.mean(times[m]) for m in (False, True))
            default = "two-phase" if km.scan_plan(K, N, sms).two_phase else "on read"
            print(f"combine {name} K={K} N={N} T'={Tm}: on read {on_read:.4f} ms, two-phase "
                  f"{two:.4f} ms (two-phase/on read {two / on_read:.3f}; {K * N * 4} bytes "
                  f"of partials a step; the plan takes {default}); runs {times}", flush=True)
        del logA, emits, delta0
    torch.cuda.empty_cache()


def scan_floor_phase(hmm, device, recs: dict[str, dict], hbm_gbps: float) -> None:
    """The persistent scan's own floor beside its time: the bytes it
    streams a step at the rate this kernel streams logA when all of it fits
    L2, plus the step's fixed cost (the pointer scan at K=128, N=1, T'=255,
    over 255), times the steps; and the card's L2 figures.  The rate is
    read from the pointer scan at N=1, T'=255 on a K whose logA has the
    size of the headline scan's streamed part, planned with no row in
    shared memory (every row streamed every step), less the fixed cost."""
    import ctypes

    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km
    from flash_viterbi_tpu_torch.runtime import build

    limits = (ctypes.c_int * 6)()
    build.check(build.kernels().fvt_device_limits(0, limits), "fvt_device_limits")
    sms = km.sm_count(device)
    Kp = -(-hmm.K // 128) * 128
    steps = HEADLINE["T"] - 1
    small = grid_inputs(128, 1, steps, device, seed=3)
    fixed_ms = elapsed_ms(lambda: k.maxplus_scan(*small[:3]), device, 9) / steps
    head = km.scan_plan(Kp, 1, sms)
    Kl = int((km.streamed_bytes(head) / 4) ** 0.5) // 4 * 4
    streamed = km.scan_plan(Kl, 1, sms, smem_bytes=km.STATIC_SMEM + 4096)
    require(streamed.rows_smem == 0, f"the L2-rate plan keeps rows in shared memory: {streamed}")
    l2_in = grid_inputs(Kl, 1, steps, device, seed=4)[:3]
    l2_ms = elapsed_ms(lambda: k.maxplus_scan(*l2_in, plan=streamed), device, 9)
    gbps = Kl * Kl * 4 * steps / ((l2_ms - steps * fixed_ms) * 1e-3) / 1e9
    print(f"L2: {limits[0]} bytes, up to {limits[1]} bytes for persisting accesses; the scan's "
          f"streaming rate with all of logA in L2 {gbps:.1f} GB/s (pointer scan K={Kl}, "
          f"{Kl * Kl * 4} bytes streamed a step, N=1, T'={steps}: {l2_ms:.4f} ms less the fixed "
          f"cost), HBM {hbm_gbps:.1f} GB/s; the fixed cost a step (K=128, N=1, T'={steps}) "
          f"{fixed_ms * 1e3:.3f} us", flush=True)
    combine_turns(device)
    for name, N, Tm in (("maxplus_scan", 1, steps), ("maxplus_scan_emitgather", 1, steps),
                        ("maxplus_scan_deltas", SEGMENTS, SEGMENTS)):
        plan = km.scan_plan(Kp, N, sms)
        moved = km.streamed_bytes(plan)
        floor_ms = Tm * (moved / (gbps * 1e9) * 1e3 + fixed_ms)
        recs[name].update(design_floor_ms=floor_ms)
        print(f"{name} (N={N}, T'={Tm}, Kp={Kp}): {recs[name]['ms']:.3f} ms; plan R={plan.R} x "
              f"C={plan.C} = {plan.blocks} blocks, {plan.rows_smem} of "
              f"{plan.rows_smem + plan.rows_streamed} tile rows in shared memory, {moved} bytes "
              f"streamed a step; design floor {floor_ms:.4f} ms (streamed bytes at the scan's "
              f"L2 streaming rate plus the fixed cost, times {Tm} steps); bound "
              f"{recs[name]['bound_ms']:.5f} ms", flush=True)


def beam_cluster(Kp: int, N: int, device) -> int:
    """The cluster size the beam scan's plan takes on this card for N lanes
    of Kp columns, B=64."""
    from flash_viterbi_tpu_torch.ops.cuda import beam as kb
    from flash_viterbi_tpu_torch.ops.cuda.maxplus import sm_count

    return kb._card_plan(device.index, sm_count(device), Kp, BEAM_WIDTH, N,
                         BEAM_SEGMENTS - 1 if N == 1 else 0).C


def valid_rows(valid) -> int:
    """Rows the longest lane of a ragged mask walks: the walk's dependent
    steps."""
    return int(valid.sum(0).max())


def kernel_phase(hmm, y, device) -> dict[str, dict]:
    """Kernels against plain versions; returns per-kernel records timed at
    the headline shapes, with the worst error over every fixture."""
    import functools

    from flash_viterbi_tpu_torch.ops import beam as bp
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kbt
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km
    from flash_viterbi_tpu_torch.ops.cuda.fold import fold_planes_plain as fold_plain

    def check_eg(args, reps: int = 0) -> dict:
        return compare("maxplus_scan_emitgather", k.maxplus_scan_emitgather,
                       km.maxplus_scan_emitgather_plain, args, device, reps)

    def check_beam(args, reps: int = 0) -> dict:
        return compare("beam_scan", shared_word(k.beam_scan, device), bp.beam_scan_plain, args,
                       device, reps)

    def check_step(args, reps: int = 0, plan=None) -> dict:
        return compare("maxplus_step_block", functools.partial(k.maxplus_step_block, plan=plan),
                       km.maxplus_step_block_plain, args, device, reps)

    head, unpadded = tables(hmm, 128, device), tables(hmm, 1, device)
    scan_in, deltas_in, valid = phase_inputs(head, y, device, seed=0)
    walk_valid = valid
    eg_in = eg_inputs(head, y, device)
    boundary, lanes16 = step_block_inputs(head, y, device)
    fold_in, fold_round, fold_top = fold_inputs(head, y, device)
    timed = (check_all(scan_in, deltas_in, valid, device, reps=9) + [check_eg(eg_in, 9)]
             + [check_beam(beam_inputs(head, y, device), 9), check_step(boundary, 9),
                compare("fold_planes", shared_word(k.fold_planes, device), fold_plain, fold_in,
                        device, 9)])
    config5_block = step_block_config5_inputs(device)
    shard = step_block_shard_inputs(head, y, device)
    steps = [check_step(lanes16, 9), check_step(config5_block, 9)] + [
        check_step(args, 9) for args in shard]
    sms = km.sm_count(device)
    many = km.step_plan(*lanes16[0].shape, lanes16[1].shape[1], sms, R=STEP_MANY_RANGES)
    require(many.blocks > sms, f"the many-tile step plan has {many.blocks} blocks")
    one = km.step_plan(*lanes16[0].shape, lanes16[1].shape[1], sms, R=1)
    step_plans = [check_step(lanes16, plan=many), check_step(lanes16, plan=one)]
    step_ties = step_block_tie_inputs(device)
    before = km.maxplus_step_block.launches
    step_plans.append(check_step(step_ties))
    require(km.maxplus_step_block.launches - before == 1,
            f"the step block at N={step_ties[0].shape[0]} made "
            f"{km.maxplus_step_block.launches - before} launches, not 1")
    ties, valid = tie_fixture(device)
    beam_seg, beam_b1 = beam_segment_inputs(head, y, device, seed=2), beam_inputs(
        head, y, device, B=1)
    others = (check_all(*phase_inputs(unpadded, y, device, seed=1), device)
              + check_all(ties, ties, valid, device)
              + check_all(*batch_inputs(head, batch_seqs(), device), device)
              + [check_eg(eg_inputs(unpadded, y, device)),
                 check_eg(tie_eg_inputs(ties, device)),
                 check_beam(beam_seg),
                 check_beam(beam_inputs(unpadded, y, device)),
                 check_beam(beam_tie_inputs(ties, valid, device)),
                 check_beam(beam_b1)] + steps + step_plans)
    print(f"maxplus_step_block: bit-exact under a plan of {many.blocks} tiles on {sms} SMs, "
          f"under a single source range, and at N={step_ties[0].shape[0]} in one launch",
          flush=True)
    for args, r in zip([boundary, lanes16, config5_block] + shard, [timed[-2]] + steps):
        (N, Ks), Kd = args[0].shape, args[1].shape[1]
        plan = km.step_plan(N, Ks, Kd, sms)
        queued = queued_ms(lambda: k.maxplus_step_block(*args), device)
        cold = cold_ms(lambda: k.maxplus_step_block(*args), device, 9)
        print(f"maxplus_step_block at (N, Ks, Kd) = ({N}, {Ks}, {Kd}): {r['ms']:.4f} ms a "
              f"timed call, {queued:.4f} ms of device time back to back (queued), {cold:.4f} "
              f"ms with L2 flushed (plain {r['plain_ms']:.3f} ms); plan "
              f"R={plan.R} x C={plan.C} x {plan.groups} lane groups = {plan.blocks} blocks, "
              f"combine {plan.combine}; bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} "
              f"({r['bytes']} bytes, {r['operations']} operations)", flush=True)
    walk_recs, _ = walk_checks(head, y, device)
    others += (beam_select_checks(device, head, y) + walk_recs + scan_grid_checks(device)
               + looped_plan_checks(device) + fold_checks(fold_in, fold_round, fold_top, device)
               + backtrack_checks(device))
    fold_times(fold_in, fold_round, fold_top, device)
    # attribution: at B=1 the fold reads one row a step, so the time is the
    # select and the step's fixed cost
    beam = shared_word(k.beam_scan, device)
    print(f"beam_scan at the segment shape (8 lanes, T'={beam_seg[1].shape[0]}, cluster of "
          f"{beam_cluster(head.Kp, 8, device)}): "
          f"{elapsed_ms(lambda: beam(*beam_seg), device, 9):.3f} ms; at the "
          f"phase-1 shape (cluster of {beam_cluster(head.Kp, 1, device)}) with B=1: "
          f"{elapsed_ms(lambda: beam(*beam_b1), device, 9):.3f} ms", flush=True)
    recs = {r["name"]: dict(r, fixtures=1) for r in timed}
    for r in others:
        rec = recs[r["name"]]
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        rec["fixtures"] += 1
    # the walks' floor: their dependent round trips at the chased latency;
    # the pointer walk's, its plan's G + L loads (the serial walk's T' and
    # the table read once for comparison: information)
    lat_us = chase_latency_us(device)
    bt_plan = kbt.backtrack_plan(len(y) - 1, 1, head.Kp, km.sm_count(device))
    bt_trips = len(y) - 1 if bt_plan.serial else bt_plan.G + bt_plan.L
    for name, trips in (("backtrack_batched", bt_trips), ("argmax_walk", valid_rows(walk_valid)),
                        ("beam_scan", len(y) - 1)):
        recs[name]["latency_floor_ms"] = trips * lat_us / 1e3
    print(f"backtrack_batched's dependent floor at the headline: {bt_trips} loads under "
          f"{bt_plan} = {bt_trips * lat_us / 1e3:.4f} ms; the serial walk's {len(y) - 1} loads "
          f"{(len(y) - 1) * lat_us / 1e3:.4f} ms; the table read once "
          f"{bound((len(y) - 1) * head.Kp * 4, 0)[0]:.6f} ms by bytes", flush=True)
    for name, r in recs.items():
        floor = (f"; latency floor {r['latency_floor_ms']:.4f} ms" if "latency_floor_ms" in r
                 else "")
        print(f"kernel {name}: bit-exact on {r['fixtures']} fixtures; {r['ms']:.3f} ms "
              f"(plain {r['plain_ms']:.3f} ms) at the headline shape; bound "
              f"{r['bound_ms']:.6f} ms by {r['bound_by']} ({r['bytes']} bytes, "
              f"{r['operations']} operations){floor}", flush=True)

    # the two pointer scans at one shape, timed in turns
    turns = {"maxplus_scan": [], "maxplus_scan_emitgather": []}
    for name, fn, args in (("maxplus_scan", k.maxplus_scan, scan_in),
                           ("maxplus_scan_emitgather", k.maxplus_scan_emitgather, eg_in),
                           ("maxplus_scan_emitgather", k.maxplus_scan_emitgather, eg_in),
                           ("maxplus_scan", k.maxplus_scan, scan_in)):
        turns[name].append(elapsed_ms(lambda: fn(*args), device, 9))
    scan_ms, eg_ms = (statistics.mean(turns[n]) for n in turns)
    print(f"in turns at N=1, T'={len(y) - 1}, Kp={head.Kp}: maxplus_scan_emitgather "
          f"{eg_ms:.3f} ms vs maxplus_scan {scan_ms:.3f} ms "
          f"({(eg_ms / scan_ms - 1) * 100:+.2f}%); runs {turns}", flush=True)
    km.raise_on_error(SHARED_ERR, "kernel phase")
    return recs


def probe_check_phase(device) -> dict[str, dict]:
    """Every probe kernel that computes a defined function against its
    plain version on the card, bit for bit, on every fixture; the beam
    probes also against the production beam_scan.  Returns per-kernel
    records: the worst error, the fixtures and the plain version's time
    at the probe's timed shape."""
    from flash_viterbi_tpu_torch.bench.harness import marginal_time
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda.maxplus import sm_count
    from flash_viterbi_tpu_torch.probes import alu, beam, copy, scan

    recs = {name: {"max_abs_err": 0.0, "fixtures": 0} for name in PROBE_KERNELS}

    def hold(name: str, got, want) -> None:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            require((g is None) == (w is None), f"{name}: outputs differ in kind")
            if g is None:
                continue
            err = max_abs_err(g, w)
            require(g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w),
                    f"{name}: kernel differs from its plain version (max abs err {err})")
            recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], err)
        recs[name]["fixtures"] += 1

    x = alu.inputs(device=device)
    ragged = alu.inputs(*PROBE_ALU_RAGGED, device=device, seed=1)
    clocks = alu.clock_buffer(device)
    for r in (alu.R, alu.RATE_R):
        hold("probe_alu", alu.probe_alu(x, r), alu.probe_alu_plain(x, r))
        hold("probe_alu", alu.probe_alu(ragged, r, clocks=clocks), alu.probe_alu_plain(ragged, r))
    recs["probe_alu"]["plain_ms"] = elapsed_ms(lambda: alu.probe_alu_plain(x, alu.R), device, 3)
    print(f"probe_alu: bit-exact at R = {alu.R}, {alu.RATE_R} on {tuple(x.shape)} and on "
          f"{PROBE_ALU_RAGGED} ({ragged.numel()} elements, an odd count), the resident grid "
          f"{clocks.shape[0]} blocks of {alu.THREADS}, the ragged call's clocks recorded on "
          f"{alu.clock_stats(clocks)['sms']} SMs", flush=True)

    cache = {}
    sms = sm_count(device)
    for shape, (K, N, Tm) in scan.SHAPES.items():
        Tc = min(Tm, PROBE_SCAN_COMPARE_TM) if K > 4096 else Tm
        args = scan.inputs(K, N, Tc, device, cache=cache)
        want = scan.probe_scan_ablation_plain(*args)
        for variant in scan.EXACT:
            hold("probe_scan_ablation", scan.probe_scan_ablation(*args, variant),
                 (want[0], None if variant == "no-hist" else want[1]))
        plans = {v: scan.ablation_plan(K, N, sms, v) for v in ("full", "all-streamed")}
        print(f"probe scan ablation {shape} (K={K}, N={N}, T'={Tc}): {', '.join(scan.EXACT)} "
              f"bit-exact (dfin, and the history where written); plan R={plans['full'].R} x "
              f"C={plans['full'].C}, {plans['full'].rows_smem} tile rows in shared memory "
              f"(all-streamed {plans['all-streamed'].rows_smem}), "
              f"{'two-phase' if plans['full'].two_phase else 'on read'}", flush=True)
    K, N, Tm = scan.SHAPES["phaseA"]
    full = scan.inputs(K, N, Tm, device, cache=cache)
    recs["probe_scan_ablation"]["plain_ms"] = elapsed_ms(
        lambda: scan.probe_scan_ablation_plain(*full), device, 1)
    del cache, full, args, want

    ties = [a if a.dtype != torch.float32 else torch.round(a * 2) / 2 + 0.0
            for a in beam.inputs(beam.B, 3968, beam.TM, device, seed=1)]
    for args in (beam.inputs(device=device), tuple(ties)):
        want = beam.probe_beam_plain(*args)
        hist, slots, _ = k.beam_scan(*args)
        require(torch.equal(hist * 256 + slots, want),
                "beam_scan differs from the plain beam scan on a probe fixture")
        hold("probe_beam_parts", beam.probe_beam_parts(*args, "full"), want)
        for variant in ("sort", "pick", "nosmem", "blockm"):
            hold("probe_beam_select", beam.probe_beam_select(*args, variant), want)
    args = beam.inputs(device=device)
    plain_ms = elapsed_ms(lambda: beam.probe_beam_plain(*args), device, 3)
    recs["probe_beam_parts"]["plain_ms"] = recs["probe_beam_select"]["plain_ms"] = plain_ms
    print("probe beam: full, sort, pick, nosmem and blockm equal the plain beam scan and "
          "beam_scan (hist * 256 + slots) on the probes' fixture (B=64, K=4096, T'=255) and "
          "a tie fixture (K=3968, values in halves)", flush=True)

    rows = copy.beam_rows(device=device)
    for x in (copy.fixture(device=device), rows):
        for name, fn, B in (("probe_copy_p1", copy.probe_copy_p1, 1),
                            ("probe_copy_p3", copy.probe_copy_p3, copy.P3_B)):
            hold(name, fn(x), x.clone())
            for ctas in (1, 3):
                plan = copy.copy_plan(x.shape[0], x[0].numel(), B, sms, ctas=ctas)
                hold(name, fn(x, plan=plan), x.clone())
    # p1, p3 and Tensor.copy_ timed alike: the device's time a call back to
    # back (queued behind a sleep, no host read in the chain; the records'
    # times) and with L2 flushed; and the slope of chains as probes.run()
    # times every probe (the host's launch cost included)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    for x in (copy.fixture(device=device), rows):
        dst = torch.empty_like(x)
        runs = (("Tensor.copy_", lambda: dst.copy_(x)),
                ("probe_copy_p1", lambda: copy.probe_copy_p1(x, err=err)),
                ("probe_copy_p3", lambda: copy.probe_copy_p3(x, err=err)))
        times = {name: (queued_ms(fn, device), cold_ms(fn, device, 9)) for name, fn in runs}
        print(f"copies of {tuple(x.shape)} float32, device time a call: " + "; ".join(
            f"{name} {q:.4f} ms back to back (queued), {c:.4f} ms with L2 flushed"
            for name, (q, c) in times.items()), flush=True)
    copy.raise_on(err, "probe copies")
    slope = marginal_time(lambda k: (lambda: [dst.copy_(rows) for _ in range(k)][-1])) * 1e3
    for name in ("probe_copy_p1", "probe_copy_p3"):
        recs[name].update(plain_ms=elapsed_ms(lambda: rows.clone(), device, 9),
                          queued_ms=times[name][0], library_ms=times["Tensor.copy_"][0],
                          library_slope_ms=slope)
    hold("probe_copy_p4", copy.probe_copy_p4(device=device),
         copy.probe_copy_p4_plain(device=device))
    hold("probe_copy_p4", copy.probe_copy_p4(255, 32, device=device),
         copy.probe_copy_p4_plain(255, 32, device=device))
    recs["probe_copy_p4"]["plain_ms"] = elapsed_ms(
        lambda: copy.probe_copy_p4_plain(device=device), device, 9)
    v, c = copy.p5_fixture(device=device)
    hold("probe_copy_p5", copy.probe_copy_p5(v, c), copy.probe_copy_p5_plain(v, c))
    best = min(zip(-v.cpu().numpy().ravel(), c.cpu().numpy().ravel()))
    require(int(copy.probe_copy_p5(v, c)[1][0, 0]) == best[1], "p5: not the numpy winner")
    recs["probe_copy_p5"]["plain_ms"] = elapsed_ms(
        lambda: copy.probe_copy_p5_plain(v, c), device, 9)
    print("probe copies: p1 and p3 on the TPU probe's fixture and on 255 rows of 3968 floats "
          "under the card's plan and plans of 1 and 3 CTAs, p4 at (4, 8) and (255, 32), p5 on "
          "its forced tie: bit-exact, no mbarrier wait timed out", flush=True)
    cluster_checks(device, recs, hold)
    return recs


def cluster_checks(device, recs: dict[str, dict], hold) -> None:
    """p4 and p5 as clusters against their plain versions, bit for bit: p4 at
    every shape of ``P4_CLUSTER_SHAPES`` by both publishes (a value per
    step and slot), p5 at every shape of ``P5_CLUSTER_SHAPES`` on both
    forced ties (the winner in the first CTA's shard, and in the last with
    its tied partner in a lower one), and p5 on the TPU probe's fixture
    against the old p5; each call's CTA 0 clock read back; the plain
    versions' time at the timed shapes."""
    from flash_viterbi_tpu_torch.probes import copy

    clocks = copy.clock_buffer(device)
    for shape, (Tm, W, C) in copy.P4_CLUSTER_SHAPES.items():
        want = copy.probe_copy_p4_cluster_plain(Tm, W, C, device)
        for pub in copy.PUBS:
            hold("probe_copy_p4_cluster",
                 copy.probe_copy_p4_cluster(Tm, W, C, pub, device, clocks=clocks), want)
            require(copy.cycles(clocks) > 0, f"p4 cluster {shape} {pub}: no clock readout")
    for (shape, (n, C)), late in itertools.product(copy.P5_CLUSTER_SHAPES.items(),
                                                   (False, True)):
        v, c = copy.p5_row(n, device, late=late)
        want = copy.probe_copy_p5_cluster_plain(v, c)
        best = min(zip(-v.cpu().numpy(), c.cpu().numpy()))
        require(int(want[1][0, 0]) == best[1], "p5 cluster: the plain version is not the winner")
        hold("probe_copy_p5_cluster", copy.probe_copy_p5_cluster(v, c, C, clocks=clocks), want)
        require(copy.cycles(clocks) > 0, f"p5 cluster {shape} late={late}: no clock readout")
    v, c = copy.p5_fixture(device=device)
    hold("probe_copy_p5_cluster", copy.probe_copy_p5_cluster(v.reshape(-1), c.reshape(-1), 1),
         copy.probe_copy_p5(v, c))
    Tm, W, C = copy.P4_CLUSTER_SHAPES["beam_c16"]
    recs["probe_copy_p4_cluster"]["plain_ms"] = elapsed_ms(
        lambda: copy.probe_copy_p4_cluster_plain(Tm, W, C, device), device, 9)
    n, C = copy.P5_CLUSTER_SHAPES["carry_row_c16"]
    v, c = copy.p5_row(n, device)
    recs["probe_copy_p5_cluster"]["plain_ms"] = elapsed_ms(
        lambda: copy.probe_copy_p5_cluster_plain(v, c), device, 9)
    print(f"probe clusters: p4 at {dict(copy.P4_CLUSTER_SHAPES)} (Tm, W, C) by {copy.PUBS}, "
          f"p5 at {dict(copy.P5_CLUSTER_SHAPES)} (n, C) on its early and late ties, and p5 on "
          f"the TPU fixture against the old p5: bit-exact, every clock read back, no mbarrier "
          f"wait timed out", flush=True)


def probe_phase(device, probe_recs: dict[str, dict], kernel_recs: dict[str, dict]) -> dict:
    """The probe path, ``probes.run()``, between a reset and a read of the
    launch counters: every probe kernel must launch.  Prints each
    variant's time beside its bound, the measured add+max rate and the
    scans' operation bound at it; fills ``probe_recs`` with each probe
    kernel's time and bound.  Returns the launches."""
    from flash_viterbi_tpu_torch import probes
    from flash_viterbi_tpu_torch.probes import alu

    t0 = time.perf_counter()
    records, launches = drive("probes", PROBE_KERNELS, lambda: probes.run(device=device))
    timed = {}
    for rec in records:
        if "skipped" in rec:
            print(f"probe {rec['probe']} {rec['variant']}: no run ({rec['skipped']})")
            continue
        if "split" in rec:
            scan_split(rec)
            continue
        # the device's time back to back where the record has it (probe_alu),
        # else the record's own time a call
        ms = rec.get("back_to_back_s", rec["per_call_s"]) * 1e3
        bound_ms, bound_by = bound(rec["bytes"], rec["operations"])
        timed.setdefault(rec["kernel"], {})[rec["variant"]] = (ms, bound_ms, bound_by)
        print(f"probe {rec['probe']} {rec['variant']} {rec.get('jax', '')}: {ms:.4f} ms a call; "
              f"bound {bound_ms:.6f} ms by {bound_by} ({rec['bytes']} bytes, "
              f"{rec['operations']} operations); {json.dumps(rec)}", flush=True)
    print(f"probes: {time.perf_counter() - t0:.1f} s", flush=True)
    first = next(r for r in records if r.get("kernel") == "probe_beam_parts")
    steps, C = first["Tm"], first["C"]
    us = {v: t[0] / steps * 1e3 for k in ("probe_beam_parts", "probe_beam_select")
          for v, t in timed[k].items()}
    print(f"beam step split, us a step (B=64, K=4096, T'={steps}, a cluster of {C}): "
          + ", ".join(f"{v} {t:.3f}" for v, t in us.items())
          + f"; row reads ~ full - no-dma = {us['full'] - us['no-dma']:.2f}; fold ~ full - "
          f"no-fold = {us['full'] - us['no-fold']:.2f}; select (radix) ~ full - no-pick = "
          f"{us['full'] - us['no-pick']:.2f}; selects in place of the radix select: "
          + ", ".join(f"{v} {us[v] - us['sort']:+.2f}" for v in
                      ("pick", "nosmem", "blockm", "onereduce")), flush=True)
    beam_sweep(device, {64: {v: us[v] for v in BEAM_SWEEP_VARIANTS}})
    floor = kernel_recs["beam_scan"]["latency_floor_ms"]  # the same T' round trips
    for name in ("probe_beam_parts", "probe_beam_select"):
        probe_recs[name]["latency_floor_ms"] = floor
    print(f"beam probes' latency floor: {steps} dependent steps at the chased round trip, "
          f"{floor:.4f} ms", flush=True)
    for name, variant in PROBE_TIMED.items():
        ms, bound_ms, bound_by = timed[name][variant]
        probe_recs[name].update(ms=ms, bound_ms=bound_ms, bound_by=bound_by, timed=variant)
        probe_recs[name].setdefault("library_ms", None)
    # p1's and p3's records: the device's time, as Tensor.copy_'s (library_ms)
    p1, p3 = (probe_recs[n] for n in ("probe_copy_p1", "probe_copy_p3"))
    lib = p1["library_ms"]
    print(f"beam rows (255 x 15872 bytes), a call: device time back to back p1 "
          f"{p1['queued_ms']:.4f} ms, p3 {p3['queued_ms']:.4f} ms, Tensor.copy_ {lib:.4f} ms "
          f"(p1/copy_ {p1['queued_ms'] / lib:.3f}, p3/copy_ {p3['queued_ms'] / lib:.3f}); the "
          f"slope of chains with no host read, the host's launch included: p1 {p1['ms']:.4f} "
          f"ms, p3 {p3['ms']:.4f} ms, Tensor.copy_ {p1['library_slope_ms']:.4f} ms; at the TPU "
          f"fixture (Tm=4, 1 KB rows), slopes: p1 {timed['probe_copy_p1']['p1'][0]:.4f} ms, p3 "
          f"{timed['probe_copy_p3']['p3'][0]:.4f} ms", flush=True)
    for rec in (p1, p3):
        rec.update(slope_ms=rec["ms"], ms=rec["queued_ms"])

    cluster_floors(device, records, us["full"], C, probe_recs)

    alu_targets({r["variant"]: r for r in records if r.get("kernel") == "probe_alu"})
    rate = next(r for r in records if r["variant"] == "vpu_peak_rate")
    on = card()
    for name in ("maxplus_scan", "maxplus_scan_deltas", "maxplus_scan_emitgather"):
        ops = kernel_recs[name]["operations"]
        print(f"{name}: operation bound {ops / on.ops_per_s * 1e3:.5f} ms at the issue rate "
              f"({on.ops_per_s:.5g} operations/s), {ops / rate['ops_per_s'] * 1e3:.5f} ms at the "
              f"measured add+max rate ({ops} operations; {kernel_recs[name]['ms']:.3f} ms "
              f"measured)", flush=True)
    try:
        print(f"probe_alu SASS: {alu.sass_counts()}", flush=True)
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"probe_alu SASS: not read ({e})", flush=True)
    return launches


def cluster_floors(device, records: list[dict], beam_step_us: float, beam_C: int,
                   probe_recs: dict[str, dict]) -> None:
    """The cluster probes beside their dependent-chain floors: the chases'
    cycles a dependent step (shared memory, a peer CTA's, a shuffle, a
    winner's compare) and an empty kernel's device time back to back (the
    launch floor, information); each p4 and p5 cluster record's device time
    back to back, CTA 0's cycles a step (p4) or a call (p5), its floor and
    share, and its chain slope; at C=16, a cluster.sync() publish against a
    remote-mbarrier publish, times the beam step's barriers, against the
    beam probes' step.  Latencies convert at the card's maximum SM clock.
    The floor at each cluster kernel's timed shape (``PROBE_TIMED``) is its
    ``latency_floor_ms`` in ``probe_recs``."""
    from flash_viterbi_tpu_torch.bench import bounds
    from flash_viterbi_tpu_torch.probes import copy

    on = card()
    lat_cyc = copy.latencies(device)
    lat_s = {k: c / on.clock_hz for k, c in lat_cyc.items()}
    empty_ms = queued_ms(lambda: copy.probe_empty(device), device)
    print(f"chases, cycles a dependent step ({copy.CHASE_HOPS} steps less {copy.CHASE_HOPS // 2}"
          f"): " + ", ".join(f"{k} {c:.2f} ({lat_s[k] * 1e9:.2f} ns)" for k, c in lat_cyc.items())
          + f" at {on.clock_hz / 1e9:.3f} GHz; empty kernel {empty_ms * 1e3:.3f} us of device "
          f"time back to back (the launch floor every one-launch probe pays)", flush=True)
    per_step = {}
    for rec in records:
        if rec.get("kernel") not in ("probe_copy_p4_cluster", "probe_copy_p5_cluster"):
            continue
        ms = rec["back_to_back_s"] * 1e3
        if rec["kernel"] == "probe_copy_p4_cluster":
            Tm, W, C = rec["shape"]
            floor = bounds.p4_floor_s(Tm, C, lat_s) * 1e3
            per_step[rec["variant"]] = rec["cycles"] / Tm
            cyc = f"{rec['cycles'] / Tm:.1f} cycles a step ({rec['cycles']} a call)"
        else:
            n, C = rec["shape"]
            floor = bounds.p5_floor_s(n, C, lat_s) * 1e3
            cyc = f"{rec['cycles']} cycles a call"
        if PROBE_TIMED[rec["kernel"]] == rec["variant"]:
            probe_recs[rec["kernel"]]["latency_floor_ms"] = floor
        print(f"cluster probe {rec['variant']} {rec['shape']}: {ms * 1e3:.3f} us of device time "
              f"back to back, {cyc}; chain floor {floor * 1e3:.3f} us ({floor / ms * 100:.1f}% "
              f"of it), with the launch floor {(floor + empty_ms) * 1e3:.3f} us; chain slope "
              f"{rec['per_call_s'] * 1e6:.3f} us", flush=True)
    for shape in ("barrier_c16", "beam_c16"):
        sync, mbar = per_step[f"p4c_{shape}_sync"], per_step[f"p4c_{shape}_mbarrier"]
        us = {k: c / on.clock_hz * 1e6 for k, c in (("sync", sync), ("mbarrier", mbar))}
        print(f"C=16 publish ({shape}, {copy.P4_CLUSTER_SHAPES[shape]}): cluster.sync() "
              f"{sync:.1f} cycles ({us['sync']:.3f} us) a step, remote mbarrier {mbar:.1f} cycles "
              f"({us['mbarrier']:.3f} us); x{BEAM_STEP_BARRIERS} barriers: "
              f"{BEAM_STEP_BARRIERS * us['sync']:.3f} us against "
              f"{BEAM_STEP_BARRIERS * us['mbarrier']:.3f} us, of a {beam_step_us:.3f} us beam "
              f"step (C={beam_C}): {BEAM_STEP_BARRIERS * us['sync'] / beam_step_us * 100:.1f}% "
              f"against {BEAM_STEP_BARRIERS * us['mbarrier'] / beam_step_us * 100:.1f}%",
              flush=True)


def scan_split(rec: dict) -> None:
    """Print one shape's scan-ablation step split (``probes.scan.split``)."""
    sp = rec["split"]
    us = {k: v * 1e6 for k, v in sp.items() if k.endswith("_step_s")}
    rate = sp["stream_bytes_per_s"]
    print(f"scan ablation step split {rec['variant'][:-len('_split')]} (K={rec['K']}, "
          f"N={rec['N']}, T'={rec['Tm']}), us a step: fixed (barrier-only) "
          f"{us['fixed_step_s']:.3f}, combine (full - no-combine) {us['combine_step_s']:.3f}, "
          f"streamed rows (full - no-stream) {us['stream_step_s']:.3f} for "
          f"{rec['streamed_bytes_a_step']} bytes a lane group ("
          + (f"{rate / 1e12:.3f} TB/s" if rate else "no rate: no time") +
          f"), fold (full - no-fold) {us['fold_step_s']:.3f}, history (full - no-hist) "
          f"{us['hist_step_s']:.3f}", flush=True)


def alu_targets(recs: dict) -> None:
    """probe_alu's two records beside the issue limit and the targets: at
    RATE_R rounds PROBE_ALU_RATE_SHARE of 64 cells a clock an SM, at R
    rounds a device time within PROBE_ALU_R_MS (each met or missed)."""
    from flash_viterbi_tpu_torch.bench import bounds

    on = card()
    limit = bounds.OPS_PER_CLOCK_SM // 2
    for variant, rec in recs.items():
        print(f"probe_alu {variant} (R={rec['R']}, {rec['shape']}): device time back to back "
              f"{rec['back_to_back_s'] * 1e3:.5f} ms, chain slope {rec['per_call_s'] * 1e3:.5f} ms; "
              f"{rec['cycles']} cycles a call on the busiest of {rec['sms']} SMs, "
              f"{rec['cells_per_clock_sm']:.3f} cells a clock an SM "
              f"({rec['cells_per_clock_sm'] / limit * 100:.1f}% of {limit}), SM clock "
              f"{rec['sm_clock_hz'] / 1e9:.4f} GHz implied (maximum {on.clock_hz / 1e9:.3f}); "
              f"{rec['cells_per_s']:.6g} cells/s", flush=True)
    share = recs["vpu_peak_rate"]["cells_per_clock_sm"] / limit
    ms = recs["vpu_peak"]["back_to_back_s"] * 1e3
    print(f"probe_alu targets: R={recs['vpu_peak_rate']['R']} at {share * 100:.1f}% of the "
          f"issue limit (target {PROBE_ALU_RATE_SHARE * 100:.0f}%: "
          f"{'met' if share >= PROBE_ALU_RATE_SHARE else 'missed'}); R={recs['vpu_peak']['R']} "
          f"{ms * 1e3:.3f} us of device time (target {PROBE_ALU_R_MS * 1e3:.1f} us: "
          f"{'met' if ms <= PROBE_ALU_R_MS else 'missed'})", flush=True)


def beam_sweep(device, known: dict) -> None:
    """full, no-pick and no-fold at B in BEAM_SWEEP_B (``known`` holds the
    probes' own B=64), us a step, and the step split from them: the select
    (full - no-pick), the row reads and the fold a beam row (the slope of
    no-pick over B) and the skeleton (no-pick at B=1 less one row)."""
    from flash_viterbi_tpu_torch.probes import beam

    us = dict(known)
    for Bw in BEAM_SWEEP_B:
        if Bw in us:
            continue
        recs = beam.run_parts(device, Bw=Bw, variants=BEAM_SWEEP_VARIANTS)
        us[Bw] = {r["variant"]: r["per_step_s"] * 1e6 for r in recs}
        print(f"beam probe at B={Bw} (a cluster of {recs[0]['C']}): " + ", ".join(
            f"{v} {t:.3f} us a step" for v, t in us[Bw].items()), flush=True)
    lo, hi = min(us), max(us)
    per_row = (us[hi]["no-pick"] - us[lo]["no-pick"]) / (hi - lo)
    print(f"beam step over B (K=4096, T'=255): select (full - no-pick) " + ", ".join(
        f"B={b} {us[b]['full'] - us[b]['no-pick']:.3f}" for b in sorted(us))
        + f" us; row reads and fold {per_row:.4f} us a beam row (no-pick's slope from B={lo} "
        f"to {hi}); skeleton {us[lo]['no-pick'] - lo * per_row:.3f} us (no-pick at B={lo} "
        f"less its rows)", flush=True)


def nonzero(counts: dict[str, int]) -> dict[str, int]:
    return {n: c for n, c in counts.items() if c}


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launches, the probes' included."""
    from flash_viterbi_tpu_torch import probes
    from flash_viterbi_tpu_torch.ops import cuda as k

    return {**k.launch_counts(), **probes.launch_counts()}


def reset_launches() -> None:
    from flash_viterbi_tpu_torch import probes
    from flash_viterbi_tpu_torch.ops import cuda as k

    k.reset_launches()
    probes.reset_launches()


def smi_clocks() -> str:
    """The card's SM clock and power draw as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def spin_up(device, seconds: float = SPIN_UP_S) -> str:
    """Keep the card busy for ``seconds`` (fp32 products) so that a decode
    phase after a stretch of host work finds the card at its working clock,
    not at the idle one; returns the clocks before and after."""
    before = smi_clocks()
    x = torch.randn((4096, 4096), device=device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(8):
            x = torch.tanh(x @ x)
        torch.cuda.synchronize(device)
    return f"SM clock, power before the spin-up {before}, after {smi_clocks()}"


def drive(label: str, needed, run):
    """Run one phase between a reset and a read of the launch counters;
    require every kernel in ``needed`` to have launched.  Returns
    (``run()``'s result, the counts)."""
    reset_launches()
    out = run()
    launches = launch_counts()
    print(f"{label}: kernel launches (warmups included): {nonzero(launches)}",
          flush=True)
    missing = [n for n in needed if launches[n] == 0]
    require(not missing, f"{label}: a kernel of the path never launched: {missing}")
    return out, launches


def oracle_verdict(hmm, y, path, oracle, exact: bool) -> str:
    """Hold ``path`` to the C oracle's: equal, or (unless ``exact``) an
    fp32 tie flip within the f64 score tolerance."""
    from flash_viterbi_tpu_torch.oracle.validate import (path_score_f64,
                                                         score_tolerance_f64)

    if np.array_equal(path, oracle):
        return "exact"
    require(not exact, "the seed-1 request must equal the C oracle exactly")
    s_got = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, path)
    s_ref = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, oracle)
    tol = score_tolerance_f64(len(y), s_ref)
    require(bool(np.isfinite(s_got)) and abs(s_got - s_ref) <= tol,
            f"f64 score {s_got} vs oracle {s_ref} (tol {tol})")
    return (f"tie-equivalent ({int((path != oracle).sum())} positions, "
            f"f64 score gap {abs(s_got - s_ref):.3g})")


def slice_phase(hmm, requests, oracles, device, witness) -> dict[str, int]:
    """Decode every request with FLASH on ``device``; check each against
    the port's CPU decode (from ``witness``), the C oracle and the analytic
    memory; return the launches."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.algorithms.flash import _memory

    K, T = hmm.K, len(requests[0])
    spun = spin_up(device)
    results, launches = drive(
        f"flash, {len(requests)} decodes",
        ("maxplus_scan", "maxplus_scan_deltas", "backtrack_batched", "argmax_walk"),
        lambda: [decode(hmm, y, "flash", num_segments=SEGMENTS, device=device)
                 for y in requests])
    want_mem = _memory(K=K, T=T, num_segments=SEGMENTS)
    for i, (y, r, oracle) in enumerate(zip(requests, results, oracles)):
        cpu_path, cpu_s = witness.get(f"flash{i}")
        require(np.array_equal(r.path, cpu_path),
                f"request {i}: {device} path differs from the CPU decode")
        verdict = oracle_verdict(hmm, y, r.path, oracle, exact=i == 0)
        require(r.memory_bytes == want_mem,
                f"request {i}: memory {r.memory_bytes} != {want_mem}")
        require(r.path.shape == (T,) and bool(((r.path >= 0) & (r.path < K)).all()),
                f"request {i}: path out of range")
        print(f"request {i}: time_s {r.time_s:.6f}, "
              f"{K * K * T / r.time_s / 1e9:.2f} G updates/s, oracle {verdict}, "
              f"cpu decode {cpu_s:.2f} s (witness), memory {r.memory_bytes}, "
              f"launches {nonzero(r.extra['launches'])}", flush=True)
    again = decode(hmm, requests[0], "flash", num_segments=SEGMENTS, device=device)
    print(f"flash request 0 again after the others: {again.time_s * 1e3:.3f} ms (first read "
          f"{results[0].time_s * 1e3:.3f} ms); {spun}", flush=True)
    return launches


def checkpoint_phase(hmm, requests, oracles, device) -> list[dict[str, int]]:
    """Decode every request with checkpoint and with fused on ``device``;
    checkpoint must equal fused bit for bit and the C oracle; returns the
    launches of both."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.algorithms import checkpoint, fused

    K, T = hmm.K, len(requests[0])
    spun = spin_up(device)
    ck, ck_launches = drive(
        f"checkpoint, {len(requests)} decodes",
        ("maxplus_scan_emitgather", "backtrack_batched"),
        lambda: [decode(hmm, y, "checkpoint", device=device) for y in requests])
    fu, fu_launches = drive(
        f"fused, {len(requests)} decodes", ("maxplus_scan", "backtrack_batched"),
        lambda: [decode(hmm, y, "fused", device=device) for y in requests])
    for i, (y, c, f, oracle) in enumerate(zip(requests, ck, fu, oracles)):
        require(np.array_equal(c.path, f.path),
                f"request {i}: checkpoint path differs from fused")
        verdict = oracle_verdict(hmm, y, c.path, oracle, exact=i == 0)
        require(c.memory_bytes == checkpoint._memory(K=K, T=T),
                f"request {i}: checkpoint memory {c.memory_bytes}")
        require(f.memory_bytes == fused._memory(K=K, T=T),
                f"request {i}: fused memory {f.memory_bytes}")
        print(f"request {i}: checkpoint {c.time_s * 1e3:.3f} ms "
              f"(memory {c.memory_bytes}, launches {nonzero(c.extra['launches'])}), "
              f"fused {f.time_s * 1e3:.3f} ms (memory {f.memory_bytes}, launches "
              f"{nonzero(f.extra['launches'])}); equal paths, oracle {verdict}", flush=True)
    again = [decode(hmm, requests[0], name, device=device).time_s * 1e3
             for name in ("checkpoint", "fused")]
    print(f"request 0 again after the others: checkpoint {again[0]:.3f} ms (first read "
          f"{ck[0].time_s * 1e3:.3f}), fused {again[1]:.3f} ms (first read "
          f"{fu[0].time_s * 1e3:.3f}); {spun}", flush=True)
    return [ck_launches, fu_launches]


def beam_phase(hmm, requests, oracles, device, cpu_device, witness,
               keep: dict) -> list[dict[str, int]]:
    """Decode every request with flash_bs and with beam on ``device``; each
    path must equal the CPU decode and the numpy mirror exactly, and each
    ``memory:`` its analytic value; request 0's paths must pass
    ``beam_path_invariants``.  Prints the f64 score gap to the C oracle's
    path, and, as information, where request 0's flash_bs path equals the
    paper's FLASH-BS (``witness``'s "c_flash_bs0") and both counts of -1.
    Puts request 0's path of each into ``keep`` by name; returns the
    launches of both."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.algorithms import beam, flash_bs
    from flash_viterbi_tpu_torch.oracle import framework
    from flash_viterbi_tpu_torch.oracle.validate import beam_path_invariants, path_score_f64

    K, T = hmm.K, len(requests[0])
    print(f"beam phase: {spin_up(device)}", flush=True)
    all_launches = []
    for name, static, mirror, memory in (
            ("flash_bs", {"beam_width": BEAM_WIDTH, "num_segments": BEAM_SEGMENTS},
             framework.flash_bs, flash_bs._memory),
            ("beam", {"beam_width": BEAM_WIDTH}, framework.beam, beam._memory)):
        results, launches = drive(
            f"{name}, {len(requests)} decodes", ("beam_scan", "backtrack_batched"),
            lambda: [decode(hmm, y, name, device=device, **static) for y in requests])
        all_launches.append(launches)
        keep[name] = results[0].path
        want_mem = memory(K=K, T=T, **static)
        require(want_mem == BEAM_MEMORY[name], f"{name}: analytic memory {want_mem}")
        for i, (y, r, oracle) in enumerate(zip(requests, results, oracles)):
            cpu = decode(hmm, y, name, device=cpu_device, warmup=False, **static)
            require(np.array_equal(r.path, cpu.path),
                    f"{name} request {i}: {device} path differs from the CPU decode")
            require(np.array_equal(r.path, mirror(hmm.A, hmm.B, hmm.Pi, y, **static)),
                    f"{name} request {i}: path differs from the numpy mirror")
            require(r.memory_bytes == want_mem,
                    f"{name} request {i}: memory {r.memory_bytes} != {want_mem}")
            require(r.path.shape == (T,) and bool(((r.path >= -1) & (r.path < K)).all()),
                    f"{name} request {i}: path out of range")
            misses = int((r.path == -1).sum())
            gap = "n/a (-1 positions)" if misses else repr(
                path_score_f64(hmm.A, hmm.B, hmm.Pi, y, oracle)
                - path_score_f64(hmm.A, hmm.B, hmm.Pi, y, r.path))
            print(f"{name} request {i}: {r.time_s * 1e3:.3f} ms, -1 positions {misses}, "
                  f"f64 score gap to the C oracle {gap}, memory {r.memory_bytes}, "
                  f"launches {nonzero(r.extra['launches'])}, cpu decode "
                  f"{cpu.time_s:.2f} s; equal to the CPU decode and the mirror",
                  flush=True)
        label = beam_path_invariants(hmm.A, hmm.B, hmm.Pi, requests[0], keep[name])
        require(label.startswith("invariants-ok"), f"{name} request 0: {label}")
        print(f"{name} request 0: {label}", flush=True)
    paper, paper_s = witness.get("c_flash_bs0")
    card_path = keep["flash_bs"]
    print(f"flash_bs request 0 against the paper's FLASH-BS (the C program's min-heap "
          f"recursion, {C_FLASH_BS}; {paper_s:.1f} s in the witness), as information: "
          f"equal at {int((card_path == paper).sum())} of {T} positions; -1 positions "
          f"{int((card_path == -1).sum())} on the card, {int((paper == -1).sum())} in the "
          f"paper's", flush=True)
    return all_launches


def beam_large_phase(device, cpu_device) -> dict[str, int]:
    """One ``decode(..., "beam", beam_width=64)`` at BEAM_LARGE's K, whose
    select takes the global scratch; the path must equal the port's CPU
    decode.  Returns the launches."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm

    t0 = time.perf_counter()
    hmm, y = make_sparse_hmm(**BEAM_LARGE)
    gen_s = time.perf_counter() - t0
    r, launches = drive(f"beam K={hmm.K}", ("beam_scan", "backtrack_batched"),
                        lambda: decode(hmm, y, "beam", beam_width=BEAM_WIDTH, device=device))
    cpu = decode(hmm, y, "beam", beam_width=BEAM_WIDTH, device=cpu_device, warmup=False)
    require(np.array_equal(r.path, cpu.path), f"beam K={hmm.K}: path differs from the CPU decode")
    require(r.path.shape == (len(y),) and bool(((r.path >= -1) & (r.path < hmm.K)).all()),
            f"beam K={hmm.K}: path out of range")
    print(f"beam K={hmm.K} (Kp {-(-hmm.K // 128) * 128}), T={len(y)}, B={BEAM_WIDTH}: "
          f"{r.time_s * 1e3:.3f} ms on the card, equal to the CPU decode ({cpu.time_s:.2f} s); "
          f"-1 positions {int((r.path == -1).sum())}; tables made in {gen_s:.1f} s; "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    return launches


def long_t_phase(hmm, device) -> dict[str, int]:
    """T=16384 through the registered checkpoint and fused decoders on
    tables already on the card: equal paths, and the checkpoint decode's
    peak allocation above what was allocated before it under 32 MiB."""
    from flash_viterbi_tpu_torch import build
    from flash_viterbi_tpu_torch.models.generate import observations
    from flash_viterbi_tpu_torch.ops import maxplus as mp
    from flash_viterbi_tpu_torch.parallel import scaling

    lh = tables(hmm, 128, device)
    y = observations(LONG_T, HEADLINE["M"], seed=1)
    args = (lh.logA, lh.logB, lh.logPi,
            torch.as_tensor(y.astype(np.int64), device=device))
    rows = {}

    def run():
        for name in ("checkpoint", "fused"):
            dec = build(name)
            dec(*args)  # warmup
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            path = dec(*args)
            end.record()
            end.synchronize()
            rows[name] = (path, start.elapsed_time(end),
                          torch.cuda.max_memory_allocated(device) - before)

    _, launches = drive(f"long T={LONG_T}",
                        ("maxplus_scan_emitgather", "backtrack_batched", "maxplus_scan"),
                        run)
    (ck, ck_ms, ck_peak), (fu, fu_ms, fu_peak) = rows["checkpoint"], rows["fused"]
    require(torch.equal(ck, fu), f"T={LONG_T}: checkpoint path differs from fused")
    require(ck.shape == (LONG_T,) and bool(((ck >= 0) & (ck < hmm.K)).all()),
            f"T={LONG_T}: path out of range")
    score = float(mp.path_score(*args, ck))
    require(np.isfinite(score), f"T={LONG_T}: path score {score}")
    require(ck_peak < LONG_T_PEAK_BYTES,
            f"T={LONG_T}: checkpoint peak {ck_peak} bytes above the tables")
    K2T = hmm.K * hmm.K * LONG_T
    print(f"long T={LONG_T}, Kp={lh.Kp}: checkpoint {ck_ms:.3f} ms "
          f"({K2T / ck_ms / 1e6:.2f} G updates/s), peak +{ck_peak} bytes "
          f"({ck_peak / 2**20:.2f} MiB); fused {fu_ms:.3f} ms "
          f"({K2T / fu_ms / 1e6:.2f} G updates/s), peak +{fu_peak} bytes "
          f"({fu_peak / 2**20:.2f} MiB); equal paths, fp32 score {score}", flush=True)
    print(f"long T={LONG_T}: single_chip_wall_model({hmm.K}, {LONG_T}) "
          f"{scaling.single_chip_wall_model(hmm.K, LONG_T) * 1e3:.3f} ms against fused "
          f"{fu_ms:.3f} ms; (T-1)K^2 / time = {hmm.K**2 * (LONG_T - 1) / fu_ms * 1e3:.4g} "
          f"updates/s against CHIP_UPDATES_PER_S {scaling.CHIP_UPDATES_PER_S:.4g}", flush=True)
    return launches


def batch_phase(hmm, device) -> list[dict[str, int]]:
    """``decode_batch(..., "fused")`` over 16 and 64 headline sequences in
    both pointer modes; every row must equal the sequence's single fused
    decode on the card.  Returns the launches of each batch."""
    from flash_viterbi_tpu_torch import build, decode_batch
    from flash_viterbi_tpu_torch.algorithms import fused

    K, T = hmm.K, HEADLINE["T"]
    log_tables = hmm.log(device=device)
    lh = tables(hmm, 128, device)
    seqs = batch_seqs()
    single = build("fused")
    singles = np.stack([
        single(lh.logA, lh.logB, lh.logPi,
               torch.as_tensor(s.astype(np.int64), device=device)).cpu().numpy()
        for s in seqs])
    all_launches = []
    for pointers, needed in (("recompute", ("maxplus_scan_deltas", "argmax_walk")),
                             ("store", ("maxplus_scan", "backtrack_batched"))):
        for Bs in BATCHES:
            r, launches = drive(
                f"batch Bs={Bs} pointers={pointers}", needed,
                lambda: decode_batch(log_tables, seqs[:Bs], "fused", device=device,
                                     pointers=pointers))
            all_launches.append(launches)
            require(np.array_equal(r.path, singles[:Bs]),
                    f"batch Bs={Bs} {pointers}: a row differs from its single decode")
            require(r.memory_bytes == Bs * fused._memory(K=K, T=T),
                    f"batch Bs={Bs} {pointers}: memory {r.memory_bytes}")
            print(f"batch Bs={Bs} pointers={pointers}: {r.time_s * 1e3:.3f} ms, "
                  f"{r.time_s * 1e3 / Bs:.3f} ms per sequence, "
                  f"{K * K * T * Bs / r.time_s / 1e9:.2f} G updates/s; "
                  f"rows equal the single decodes", flush=True)
    return all_launches


def sharded_phase(hmm, requests, oracles, device, cpu_device):
    """The four requests through ``decode_batch`` on a (1, 1, 1) mesh on
    ``device``: every row against the C oracle, request 0 against the CPU
    sharded decode bit for bit, ``memory:`` 4 x flash's.  Returns (the
    (4, T) paths, the launches)."""
    from flash_viterbi_tpu_torch import decode_batch, make_mesh
    from flash_viterbi_tpu_torch.algorithms.flash import _memory

    K, T = hmm.K, len(requests[0])
    ys = np.stack(requests)
    r, launches = drive(f"sharded (1, 1, 1), {len(ys)} sequences", SHARDED_NEEDS,
                        lambda: decode_batch(hmm, ys, mesh=make_mesh(1, 1, 1),
                                             num_segments=SEGMENTS, device=device))
    cpu = decode_batch(hmm, ys[:1], mesh=make_mesh(1, 1, 1), num_segments=SEGMENTS,
                       device=cpu_device, warmup=False)
    require(np.array_equal(r.path[:1], cpu.path),
            "sharded request 0: the card's path differs from the CPU sharded decode")
    require(r.memory_bytes == len(ys) * _memory(K=K, T=T, num_segments=SEGMENTS),
            f"sharded: memory {r.memory_bytes}")
    require(r.algorithm == "batched:flash"
            and r.extra["mesh"] == {"data": 1, "seq": 1, "state": 1},
            f"sharded: {r.algorithm}, mesh {r.extra['mesh']}")
    require(r.path.shape == ys.shape and bool(((r.path >= 0) & (r.path < K)).all()),
            "sharded: paths out of range")
    verdicts = [oracle_verdict(hmm, y, path, oracle, exact=i == 0)
                for i, (y, path, oracle) in enumerate(zip(requests, r.path, oracles))]
    print(f"sharded (1, 1, 1), {len(ys)} sequences: {r.time_s * 1e3:.3f} ms "
          f"({K * K * T * len(ys) / r.time_s / 1e9:.2f} G updates/s), memory "
          f"{r.memory_bytes}, launches {nonzero(r.extra['launches'])}; oracle "
          f"{verdicts}; request 0 equals the CPU sharded decode ({cpu.time_s:.2f} s)",
          flush=True)
    return r.path, launches


def run_ranks(job: dict) -> tuple[list[dict], float]:
    """Start one process per rank of ``job["mesh"]``, all on this card,
    joined over gloo (``launch_workers``: this script with rank arguments,
    a file:// store).  Returns each rank's record (its paths, decode ms,
    launches; with ``job["fuzz"]``, rank 0's also the fuzz draws' results,
    ``torch_fuzz_sharded.world_results``) and the seconds the ranks took,
    start-up included."""
    from flash_viterbi_tpu_torch.parallel.multihost import launch_workers
    from scripts.torch_fuzz_sharded import world_results

    n = int(np.prod(job["mesh"]))
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        launch_workers(os.path.abspath(__file__), n, out, timeout=RANK_TIMEOUT_S,
                       env={"FVT_SMOKE_JOB": json.dumps(job)})
        wall = time.perf_counter() - t0
        recs = []
        for r in range(n):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                rec = json.load(f)
            rec["paths"] = np.load(os.path.join(out, f"rank{r}.npy"))
            recs.append(rec)
        if job.get("fuzz"):
            recs[0]["fuzz"] = world_results(job["fuzz"], n, out)
    return recs, wall


class Witness:
    """The worker processes that make WITNESS_JOBS on the host
    (``witness_main``: this script with ``--cpu-witness``, no card
    visible) while the card's phases run."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="fvt_witness_")
        self.waited = 0.0
        self.worker = {tag: k for k, jobs in enumerate(WITNESS_JOBS) for tag, *_ in jobs}
        self.logs = [open(os.path.join(self.dir, f"log{k}"), "w")
                     for k in range(len(WITNESS_JOBS))]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-witness", self.dir, str(k)],
            stdout=log, stderr=subprocess.STDOUT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
            for k, log in enumerate(self.logs)]

    def get(self, tag: str) -> tuple[np.ndarray, float]:
        """(``tag``'s path, the seconds its worker took for it), waiting
        for it; raises with the worker's log if it failed or took too long."""
        k = self.worker[tag]
        rec = os.path.join(self.dir, f"{tag}.json")
        t0 = time.perf_counter()
        while not os.path.exists(rec):
            waited = time.perf_counter() - t0
            if self.procs[k].poll() is not None or waited > WITNESS_TIMEOUT_S:
                self.logs[k].flush()
                with open(os.path.join(self.dir, f"log{k}")) as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"CPU witness {k} has no {tag!r} (exit code "
                                   f"{self.procs[k].poll()}, waited {waited:.0f} s): {tail}")
            time.sleep(0.1)
        self.waited += time.perf_counter() - t0
        with open(rec) as f:
            secs = json.load(f)["s"]
        return np.load(os.path.join(self.dir, f"{tag}.npy")), secs

    def record(self, tag: str) -> dict:
        """A fuzz engine job's reference record, waiting for its worker."""
        self.get(tag)
        with open(os.path.join(self.dir, f"{tag}.rec.json")) as f:
            return json.load(f)

    def problem(self, key: str) -> tuple:
        """(HMM, observations) of DYN_FIXTURES[key], as its worker saved
        them (waiting for the worker's record)."""
        from flash_viterbi_tpu_torch.models.hmm import HMM

        self.get(key)
        with np.load(os.path.join(self.dir, f"{key}_tables.npz")) as f:
            return HMM(f["A"], f["B"], f["Pi"]), f["y"]

    def stop(self) -> None:
        for proc, log in zip(self.procs, self.logs):
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def witness_main(outdir: str, k: str) -> None:
    """``Witness`` worker ``k``: its WITNESS_JOBS, each the port's CPU
    decode of a headline request (or, "prefix", of request 0's first
    SIEVE_DYN_PREFIX symbols), the SIEVE decoder's oracle at its mirror
    fixture (request None), or a DYN_FIXTURES entry's path (request its
    key), the paper's FLASH-BS mirror ("c_flash_bs"), or a fuzz job: the
    C oracle's path of a wide draw, or an engine
    draw's reference record (``<tag>.rec.json``: the port's CPU pair lists
    and the oracles'); each path saved as ``<tag>.npy`` and its seconds as
    ``<tag>.json``, which is renamed into place last."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm

    torch.set_num_threads(WITNESS_THREADS)
    hmm, requests = headline()
    for tag, name, i, static in WITNESS_JOBS[int(k)]:
        t0 = time.perf_counter()
        if name == "fuzz_wide":
            from scripts.torch_fuzz_midscale import oracle_path

            path = oracle_path("wide", FUZZ_WIDE[i])
        elif name == "fuzz_engines":
            from scripts.torch_fuzz_engines import DEFAULT, draws, reference

            with open(os.path.join(outdir, f"{tag}.rec.json"), "w") as f:
                json.dump(reference(draws(FUZZ_ENGINES, DEFAULT[1])[i], cpu_decode=True), f)
            path = np.zeros(0, dtype=np.int64)
        elif name == "c_flash_bs":
            from flash_viterbi_tpu_torch.oracle import reference

            path = reference.flash_bs(hmm.A, hmm.B, hmm.Pi, requests[i], **static)
        elif i is None:
            path = sieve_mirror(name, *make_sparse_hmm(**dict(HEADLINE, K=SIEVE_MIRROR_K[name])))
        elif i == "prefix":
            path = decode(hmm, requests[0][:SIEVE_DYN_PREFIX], name, device="cpu",
                          warmup=False).path
        elif isinstance(i, str):
            path = dyn_reference(i, outdir)
        else:
            path = decode(hmm, requests[i], name, device="cpu", warmup=False, **static).path
        secs = time.perf_counter() - t0
        np.save(os.path.join(outdir, f"{tag}.npy"), np.asarray(path))
        with open(os.path.join(outdir, f"{tag}.part"), "w") as f:
            json.dump({"s": secs}, f)
        os.replace(os.path.join(outdir, f"{tag}.part"), os.path.join(outdir, f"{tag}.json"))
        print(f"{tag}: {secs:.1f} s", flush=True)


def check_ranks(label: str, recs: list[dict], want: np.ndarray, wall: float) -> None:
    """Every rank's paths must equal ``want`` bit for bit, and every rank
    must have launched the step block."""
    for rec in recs:
        require(np.array_equal(rec["paths"], want),
                f"{label} rank {rec['rank']}: paths differ from the one-rank run")
        require(rec["launches"].get("maxplus_step_block", 0) > 0,
                f"{label} rank {rec['rank']}: maxplus_step_block never launched")
    times = ", ".join(f"rank {rec['rank']} {tuple(rec['coords'])}: {rec['ms']:.3f} ms"
                      for rec in recs)
    print(f"{label}, {len(recs)} ranks time-sliced on one card (not several cards): "
          f"{times}; launches of rank 0 {recs[0]['launches']}; column shard of logA "
          f"{recs[0]['shard_bytes']} bytes a rank; every rank's paths equal the "
          f"one-rank run; {wall:.1f} s with start-up", flush=True)


def fuzz_sharded_draws(world: int) -> list[dict]:
    """The first FUZZ_SHARDED draws of distinct meshes that
    ``torch_fuzz_sharded.py``'s default run gives a world of ``world``
    ranks (draw i goes to ``WORLDS[i % 3]``)."""
    from scripts.torch_fuzz_sharded import DEFAULT, WORLDS, draw

    out, seed = [], DEFAULT[1] + WORLDS.index(world)
    while len(out) < FUZZ_SHARDED:
        p = draw(seed, world)
        if all(q["mesh"] != p["mesh"] for q in out):
            out.append(p)
        seed += len(WORLDS)
    return out


def multi_rank_phase(want: np.ndarray) -> None:
    """The headline requests on each mesh of RANK_MESHES, every rank on this
    card; each rank's paths must equal the one-rank phase's.  Then each
    world runs its fuzz draws (``fuzz_sharded_draws``; meshes of its size
    drawn, every rank held to the single-device flash decode)."""
    from scripts.torch_fuzz_sharded import ctx

    for shape in RANK_MESHES:
        world = int(np.prod(shape))
        recs, wall = run_ranks({"mesh": shape, "problem": "headline",
                                "segments": SEGMENTS, "microbatch": 1, "warmup": True,
                                "fuzz": fuzz_sharded_draws(world)})
        check_ranks(f"sharded {shape}", recs, want, wall)
        for p, fails, rec0 in recs[0]["fuzz"]:
            require(not fails, f"fuzz sharded draw {ctx(p)}: {fails}")
            print(f"fuzz sharded, world of {world} ranks on the card: ok {ctx(p)} "
                  f"path={rec0['path']} rank 0: {rec0['ms']:.1f} ms sharded, "
                  f"{rec0['s']:.1f} s with its references", flush=True)


def config5_phase(device) -> list[dict[str, int]]:
    """Config-5's K (T cut to 4096, 2 sequences): the (1, 1, 1) mesh in this
    process, then ``decode_batch(..., "flash_long", num_segments=16)``
    (the batched pipeline) against ``decode_batch(..., "flash")`` on the same
    tables, its time and peak above the tables printed beside ``memory:``,
    then ``config5_script_step`` on those tables, then CONFIG5_MESH as
    ranks on the card, each uploading only its
    column shard of the tables, memory-mapped from .npy files.  Equal paths,
    in range, finite fp32 scores.  Returns the launches of the (1, 1, 1) run
    and of the flash_long batch."""
    from flash_viterbi_tpu_torch import LogHMM, decode_batch
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, observations
    from flash_viterbi_tpu_torch.ops import maxplus as mp
    from flash_viterbi_tpu_torch.parallel.sharded import flash_decode_sharded, make_mesh

    t0 = time.perf_counter()
    hmm, y = make_sparse_hmm(**CONFIG5)
    lh = hmm.log(device="cpu")  # K=16384: no padding
    del hmm
    ys = np.stack([y] + [observations(CONFIG5["T"], CONFIG5["M"], seed=s)
                         for s in range(2, CONFIG5_BATCH + 1)])
    gen_s = time.perf_counter() - t0
    K, T = CONFIG5["K"], CONFIG5["T"]
    with tempfile.TemporaryDirectory() as tables:
        for name, t in (("logA", lh.logA), ("logB", lh.logB), ("logPi", lh.logPi)):
            np.save(os.path.join(tables, f"{name}.npy"), t.numpy())
        np.save(os.path.join(tables, "ys.npy"), ys)
        logA, logB, logPi = (t.to(device) for t in (lh.logA, lh.logB, lh.logPi))
        del lh

        def run():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            paths = flash_decode_sharded(make_mesh(), logA, logB, logPi, ys,
                                         num_segments=SEGMENTS,
                                         microbatch=CONFIG5_MICROBATCH)
            end.record()
            end.synchronize()
            return paths, start.elapsed_time(end)

        (paths, ms), launches = drive(f"config-5 K={K}, T={T}, (1, 1, 1)", SHARDED_NEEDS, run)
        yd = torch.as_tensor(ys.astype(np.int64), device=device)
        scores = [float(mp.path_score(logA, logB, logPi, yd[b], paths[b]))
                  for b in range(len(ys))]
        require(tuple(paths.shape) == ys.shape and bool(((paths >= 0) & (paths < K)).all()),
                "config-5: paths out of range")
        require(all(np.isfinite(scores)), f"config-5: path scores {scores}")
        print(f"config-5 K={K}, T={T} (cut from 65536), {len(ys)} sequences in "
              f"microbatches of {CONFIG5_MICROBATCH}, {SEGMENTS} segments, (1, 1, 1): "
              f"{ms:.3f} ms, no warmup "
              f"({K * K * T * len(ys) / ms / 1e6:.2f} G updates/s), fp32 scores {scores}; "
              f"tables made in {gen_s:.1f} s", flush=True)
        want = paths.cpu().numpy()
        del paths
        dev_tables = LogHMM(logA, logB, logPi, K)
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        r, long_launches = drive(
            f"config-5 flash_long batch K={K}, T={T}", LONG_BATCH_NEEDS,
            lambda: decode_batch(dev_tables, ys, "flash_long", num_segments=SEGMENTS,
                                 device=device))
        peak = torch.cuda.max_memory_allocated(device) - before
        only(long_launches, LONG_BATCH_NEEDS)
        flash = decode_batch(dev_tables, ys, "flash", num_segments=SEGMENTS, device=device,
                             warmup=False)
        require(np.array_equal(r.path, flash.path),
                "config-5: the flash_long batch differs from flash's decode_batch")
        print(f"config-5 flash_long batch of {len(ys)}, {SEGMENTS} segments: time_s "
              f"{r.time_s:.6f} ({K * K * T * len(ys) / r.time_s / 1e9:.2f} G updates/s; flash's "
              f"decode_batch {flash.time_s:.6f} s, no warmup), peak +{peak} bytes "
              f"({peak / 2**30:.2f} GiB) above the tables against memory: {r.memory_bytes}; "
              f"equal to flash's decode_batch, launches {nonzero(r.extra['launches'])}",
              flush=True)
        del dev_tables
        config5_script_step(logA, logB, logPi, tables, y, device)
        del logA, logB, logPi
        torch.cuda.empty_cache()
        recs, wall = run_ranks({"mesh": CONFIG5_MESH, "problem": tables,
                                "segments": SEGMENTS, "microbatch": CONFIG5_MICROBATCH,
                                "warmup": False})
    check_ranks(f"config-5 {CONFIG5_MESH}, no warmup", recs, want, wall)
    return [launches, long_launches]


def config5_script_step(logA, logB, logPi, tables: str, y, device) -> None:
    """``scripts/torch_config5.py``'s functions on config-5's tables (on the
    card; the scores read the ``.npy`` copies in ``tables``), T cut to
    CONFIG5_SCRIPT["T"], at each segment count: a first call into a
    temporary score file, gates 1-3; a resumed call that decodes only the
    new batch (its launches half the first call's, every kernel alike);
    the resumed scores and paths equal a fresh run's."""
    from scripts import torch_config5 as c5

    t0 = time.perf_counter()
    cfg = CONFIG5_SCRIPT
    host = tuple(np.load(os.path.join(tables, f"{name}.npy"), mmap_mode="r")
                 for name in ("logA", "logB", "logPi"))
    prob = c5.Problem(logA, logB, logPi, host=host, y0=np.asarray(y[:cfg["T"]]),
                      device=device, card=c5.card_line())
    group = c5.longform.GROUP_STEPS
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for N in cfg["segments"]:
            out, fresh_out = (os.path.join(tmp, f"{name}{N}.jsonl") for name in ("run", "fresh"))
            label = f"config-5 script K={prob.K}, T={prob.T}, {N} segments"
            first, launches = drive(f"{label}, {cfg['first']} sequences", LONG_BATCH_NEEDS,
                                    lambda: c5.decode_all(prob, cfg["batch"], cfg["first"], N,
                                                          group, out, lines.append))
            verdicts = c5.gates(prob, first, N, None, lines.append)
            require(all(v[0] for v in verdicts.values()),
                    f"{label}: gates {verdicts}")
            resumed, more = drive(f"{label}, resumed to {cfg['resumed']}", LONG_BATCH_NEEDS,
                                  lambda: c5.decode_all(prob, cfg["batch"], cfg["resumed"], N,
                                                        group, out, lines.append))
            require(resumed.decoded == [(cfg["first"], cfg["resumed"])]
                    and all(launches[k] == 2 * more[k] for k in launches),
                    f"{label}: the resumed call decoded {resumed.decoded}, launches "
                    f"{nonzero(more)} against the first call's {nonzero(launches)}")
            fresh = c5.decode_all(prob, cfg["batch"], cfg["resumed"], N, group, fresh_out,
                                  lines.append)
            require(np.array_equal(fresh.scores, resumed.scores)
                    and fresh.hashes == resumed.hashes,
                    f"{label}: resumed scores {resumed.scores} against fresh {fresh.scores}")
            print(f"{label}: gates {({g: v[0] for g, v in verdicts.items()})}, the resumed "
                  f"call decoded sequences {resumed.decoded} (launches {nonzero(more)} against "
                  f"{nonzero(launches)}), its f64 scores {resumed.scores.tolist()} equal a "
                  f"fresh run's", flush=True)
    print(f"config-5 script step: {time.perf_counter() - t0:.1f} s", flush=True)


def peak_run(dec, args, device):
    """A warmup call of ``dec`` (which also makes what the decoder keeps
    across calls, a transposed logA), then one timed call: (path, ms,
    peak bytes allocated above what was allocated before it)."""
    dec(*args)
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    path = dec(*args)
    end.record()
    end.synchronize()
    return path, start.elapsed_time(end), torch.cuda.max_memory_allocated(device) - before


def lean_verdict(hmm, y, path, oracle, segments: int) -> str:
    """A lean path equals the C oracle's, or else the f32 FLASH mirror's
    (the C recursion); the mirror runs only on a mismatch."""
    from flash_viterbi_tpu_torch.oracle.validate import arbitrate_flash_tie_flip

    if np.array_equal(path, oracle):
        return "exact"
    t0 = time.perf_counter()
    verdict = arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, path, segments)
    require(verdict == "mirror-exact", f"lean path differs from the C oracle at "
            f"{int((path != oracle).sum())} positions and the mirror says {verdict!r}")
    return (f"mirror-exact ({int((path != oracle).sum())} positions off vanilla; mirror "
            f"{time.perf_counter() - t0:.1f} s)")


def only(launches: dict, names) -> None:
    extra = {n: c for n, c in launches.items() if c and n not in names}
    require(not extra, f"kernels outside the path launched: {extra}")


def lean_phase(hmm, requests, oracles, device, cpu_device) -> list[dict[str, int]]:
    """The four requests through ``decode(..., "flash", mode="lean",
    num_segments=16)``, request 0 again at lean_leaf=0: each path equals
    the C oracle or the f32 mirror, request 0 the CPU lean decode, memory
    its analytic value; each peak above the tables within the working-set
    formula.  Returns the launches."""
    from flash_viterbi_tpu_torch import build, decode
    from flash_viterbi_tpu_torch.algorithms.auto import device_working_set
    from flash_viterbi_tpu_torch.algorithms.flash import _memory

    K, T = hmm.K, len(requests[0])
    spun = spin_up(device)
    results, launches = drive(
        f"flash lean, {len(requests)} decodes", LEAN_NEEDS,
        lambda: [decode(hmm, y, "flash", mode="lean", num_segments=SEGMENTS, device=device)
                 for y in requests])
    only(launches, LEAN_NEEDS)
    want_mem = _memory(K=K, T=T, num_segments=SEGMENTS)
    for i, (y, r, oracle) in enumerate(zip(requests, results, oracles)):
        verdict = lean_verdict(hmm, y, r.path, oracle, SEGMENTS)
        require(r.memory_bytes == want_mem, f"lean request {i}: memory {r.memory_bytes}")
        print(f"lean request {i}: {r.time_s * 1e3:.3f} ms, oracle {verdict}, memory "
              f"{r.memory_bytes}, launches {nonzero(r.extra['launches'])}", flush=True)
    t0 = time.perf_counter()
    cpu = decode(hmm, requests[0], "flash", mode="lean", num_segments=SEGMENTS,
                 device=cpu_device, warmup=False)
    require(np.array_equal(results[0].path, cpu.path),
            "lean request 0: the card's path differs from the CPU lean decode")
    print(f"lean request 0 equals the CPU lean decode ({time.perf_counter() - t0:.1f} s); "
          f"{spun}", flush=True)
    r0, l0 = drive("flash lean lean_leaf=0, request 0", LEAN_ONLY_ROUNDS,
                   lambda: decode(hmm, requests[0], "flash", mode="lean", lean_leaf=0,
                                  num_segments=SEGMENTS, device=device))
    only(l0, LEAN_ONLY_ROUNDS)
    print(f"lean lean_leaf=0 request 0: {r0.time_s * 1e3:.3f} ms, oracle "
          f"{lean_verdict(hmm, requests[0], r0.path, oracles[0], SEGMENTS)}", flush=True)
    lh = tables(hmm, 128, device)
    args = (lh.logA, lh.logB, lh.logPi,
            torch.as_tensor(requests[0].astype(np.int64), device=device))
    for leaf in (64, 0):
        static = {"mode": "lean", "num_segments": SEGMENTS, "lean_leaf": leaf}
        _, ms, peak = peak_run(build("flash", **static), args, device)
        limit = device_working_set("flash", static, lh.Kp, T)
        require(peak <= limit, f"lean lean_leaf={leaf}: peak +{peak} bytes above the "
                f"tables, over the working-set formula's {limit}")
        print(f"lean lean_leaf={leaf}: peak +{peak} bytes above the tables (formula {limit}, "
              f"{peak / limit * 100:.1f}%), {ms:.3f} ms", flush=True)
    return [launches, l0]


def lean_long_phase(hmm, device) -> dict[str, int]:
    """Lean mode at T=16384 on the headline tables: finite, within
    dp_divergence_tolerance_f64 of fused's path by f64 score, its peak
    within the formula; timed beside fused and checkpoint."""
    from flash_viterbi_tpu_torch import build
    from flash_viterbi_tpu_torch.algorithms.auto import device_working_set
    from flash_viterbi_tpu_torch.models.generate import observations
    from flash_viterbi_tpu_torch.oracle.validate import (dp_divergence_tolerance_f64,
                                                         path_score_f64)

    lh = tables(hmm, 128, device)
    y = observations(LONG_T, HEADLINE["M"], seed=1)
    args = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(y.astype(np.int64), device=device))
    lean = {"mode": "lean", "num_segments": SEGMENTS}
    rows = {}

    def run():
        for name, static in (("flash", lean), ("fused", {}), ("checkpoint", {})):
            rows[name] = peak_run(build(name, **static), args, device)

    _, launches = drive(f"long T={LONG_T}, lean, fused and checkpoint", LEAN_NEEDS, run)
    (path, ms, peak), fused = rows["flash"], rows["fused"]
    p, f = path.cpu().numpy(), fused[0].cpu().numpy()
    s_lean = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, p)
    s_fused = path_score_f64(hmm.A, hmm.B, hmm.Pi, y, f)
    tol = dp_divergence_tolerance_f64(LONG_T, s_fused)
    require(p.shape == (LONG_T,) and bool(((p >= 0) & (p < hmm.K)).all())
            and np.isfinite(s_lean) and abs(s_lean - s_fused) <= tol,
            f"lean T={LONG_T}: f64 score {s_lean} vs fused {s_fused} (tolerance {tol})")
    limit = device_working_set("flash", lean, lh.Kp, LONG_T)
    require(peak <= limit, f"lean T={LONG_T}: peak +{peak} bytes over the formula's {limit}")
    print(f"long T={LONG_T}: lean {ms:.3f} ms, peak +{peak} bytes (formula {limit}, "
          f"{peak / limit * 100:.1f}%), {int((p != f).sum())} positions off fused, f64 score "
          f"gap {abs(s_lean - s_fused):.4g} (tolerance {tol:.4g}); fused "
          f"{fused[1]:.3f} ms (peak +{fused[2]}), checkpoint {rows['checkpoint'][1]:.3f} ms "
          f"(peak +{rows['checkpoint'][2]})", flush=True)
    return launches


def design_phase(device) -> list[dict[str, int]]:
    """docs/DESIGN.md section 1 on the card: lean equals the f32 FLASH
    mirror bit for bit, pointer mode is mirror-exact or tie-equivalent;
    prints each one's positions off vanilla."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm
    from flash_viterbi_tpu_torch.oracle import native, reference
    from flash_viterbi_tpu_torch.oracle.validate import arbitrate_flash_tie_flip

    hmm, y = make_sparse_hmm(**DESIGN_CHECK)
    lean, l_launch = drive("DESIGN check, lean", LEAN_NEEDS, lambda: decode(
        hmm, y, "flash", mode="lean", num_segments=SEGMENTS, device=device))
    ptr, p_launch = drive("DESIGN check, pointer", ("maxplus_scan", "argmax_walk"),
                          lambda: decode(hmm, y, "flash", num_segments=SEGMENTS, device=device))
    t0 = time.perf_counter()
    mirror = reference.flash(hmm.A, hmm.B, hmm.Pi, y, threads=SEGMENTS, numerics="f32")
    mirror_s = time.perf_counter() - t0
    require(np.array_equal(lean.path, mirror), "DESIGN check: lean differs from the f32 mirror")
    verdict = ("mirror-exact" if np.array_equal(ptr.path, mirror)
               else arbitrate_flash_tie_flip(hmm.A, hmm.B, hmm.Pi, y, ptr.path, SEGMENTS))
    require(verdict in ("mirror-exact", "tie-equivalent"),
            f"DESIGN check: pointer mode's arbiter verdict {verdict!r}")
    vanilla = native.vanilla(hmm.A, hmm.B, hmm.Pi, y)
    print(f"DESIGN check K={hmm.K}, T={len(y)}, N={SEGMENTS}: lean equals the f32 mirror "
          f"({mirror_s:.1f} s), {int((lean.path != vanilla).sum())} positions off vanilla "
          f"(the C recursion: 5); pointer {verdict}, {int((ptr.path != vanilla).sum())} "
          f"positions off vanilla; lean {lean.time_s * 1e3:.3f} ms, pointer "
          f"{ptr.time_s * 1e3:.3f} ms", flush=True)
    return [l_launch, p_launch]


def auto_phase(hmm, requests, oracles, device) -> list[dict[str, int]]:
    """``decode(..., "auto")`` on the four headline requests, AUTO_SHAPES,
    the headline under a budget one byte below its choice's working set,
    and AUTO_LEAN under a budget of lean's working set: each path equals
    its chosen decoder's own decode on the card bit for bit and the C
    oracle under phase 4's rule where K^2 T <= ORACLE_MAX_CELLS;
    ``memory:`` is the chosen decoder's figure at the logical K."""
    from flash_viterbi_tpu_torch import build, decode
    from flash_viterbi_tpu_torch.algorithms.auto import choose, device_working_set
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, observations
    from flash_viterbi_tpu_torch.oracle import native

    def problem(K, T):
        other = hmm if K == hmm.K else make_sparse_hmm(K=K, M=HEADLINE["M"], T=T,
                                                       prob=HEADLINE["prob"], seed=1)[0]
        return other, observations(T, HEADLINE["M"], seed=1)

    Kp = tables(hmm, 128, "cpu").Kp
    T = len(requests[0])
    cases = [(f"headline request {i}", hmm, y, {}, oracle)
             for i, (y, oracle) in enumerate(zip(requests, oracles))]
    cases += [(f"K={K} T={Tc}", *problem(K, Tc), {}, None) for K, Tc in AUTO_SHAPES]
    budget = device_working_set(*choose(Kp, T), Kp, T) - 1
    cases.append((f"headline request 0, budget {budget} bytes", hmm, requests[0],
                  {"memory_budget_bytes": budget}, oracles[0]))
    K, Tc, over = AUTO_LEAN
    lean_hmm, lean_y = problem(K, Tc)
    Kpl = -(-K // 128) * 128
    budget = device_working_set("flash", {"mode": "lean", **over}, Kpl, Tc)
    cases.append((f"K={K} T={Tc} {over}, budget {budget} bytes", lean_hmm, lean_y,
                  {"memory_budget_bytes": budget, **over}, None))
    all_launches = []
    for label, prob, y, static, oracle in cases:
        over = {k: v for k, v in static.items() if k != "memory_budget_bytes"}
        Kpc = -(-prob.K // 128) * 128
        name, kw = choose(Kpc, len(y), static.get("memory_budget_bytes"), static=over)
        r, launches = drive(f"auto {label}", (), lambda: decode(prob, y, "auto", device=device,
                                                                **static))
        all_launches.append(launches)
        own = decode(prob, y, name, device=device, **kw)
        require(np.array_equal(r.path, own.path),
                f"auto {label}: path differs from {name} {kw}'s own decode")
        want_mem = build(name, **kw).analytic_memory(K=prob.K, T=len(y))
        require(r.memory_bytes == want_mem, f"auto {label}: memory {r.memory_bytes} != "
                f"{name}'s {want_mem}")
        verdict = "not checked (K^2 T above the oracle's cells)"
        if prob.K * prob.K * len(y) <= ORACLE_MAX_CELLS:
            if oracle is None:
                oracle = native.vanilla(prob.A, prob.B, prob.Pi, y)
            verdict = oracle_verdict(prob, y, r.path, oracle, exact=False)
        print(f"auto {label}: choose({Kpc}, {len(y)}) = {name} {kw}, {r.time_s * 1e3:.3f} ms, "
              f"equal to {name}'s own decode ({own.time_s * 1e3:.3f} ms), oracle {verdict}, "
              f"memory {r.memory_bytes}", flush=True)
    require(name == "flash" and kw.get("mode") == "lean",
            f"auto {label}: the budget chose {name} {kw}, not lean")
    return all_launches


def harness_phase(device) -> list[dict[str, int]]:
    """The port's ``bench.harness.sweep`` at the headline over every
    decoder and ``auto``, into a temporary CSV directory: every parity is
    True, "mirror-exact" or "tie-equivalent" and every file's header is
    CSV_FIELDS.  Returns the launches."""
    import csv

    from flash_viterbi_tpu_torch.bench.harness import CSV_FIELDS, RunConfig, sweep

    base = dict(K=HEADLINE["K"], M=HEADLINE["M"], T=HEADLINE["T"], prob=HEADLINE["prob"],
                seed=HEADLINE["seed"], device=str(device))
    configs = [RunConfig(algorithm="vanilla", **base),
               RunConfig(algorithm="flash", num_segments=SEGMENTS, **base),
               RunConfig(algorithm="flash", num_segments=SEGMENTS, extra={"mode": "lean"},
                         **base),
               RunConfig(algorithm="checkpoint", **base), RunConfig(algorithm="fused", **base),
               RunConfig(algorithm="flash_bs", beam_width=BEAM_WIDTH,
                         num_segments=BEAM_SEGMENTS, **base),
               RunConfig(algorithm="beam", beam_width=BEAM_WIDTH, **base),
               RunConfig(algorithm="auto", **base)]
    with tempfile.TemporaryDirectory() as csv_dir:
        rows, launches = drive("harness sweep", ("maxplus_scan", "fold_planes", "beam_scan"),
                               lambda: sweep(configs, csv_dir=csv_dir))
        for name in sorted(os.listdir(csv_dir)):
            with open(os.path.join(csv_dir, name)) as f:
                header = next(csv.reader(f))
            require(header == CSV_FIELDS, f"{name}: header {header}")
    for cfg, row in zip(configs, rows):
        require(row["parity"] in HARNESS_OK,
                f"harness {cfg.algorithm} {cfg.extra}: parity {row['parity']!r}")
        print("harness row: " + ",".join(str(row[k]) for k in CSV_FIELDS), flush=True)
    return [launches]


def lean_auto_harness_phase(hmm, requests, oracles, device, cpu_device) -> list[dict[str, int]]:
    """Lean, auto and the harness; prints the phase's wall time."""
    t0 = time.perf_counter()
    launches = (lean_phase(hmm, requests, oracles, device, cpu_device)
                + [lean_long_phase(hmm, device)] + design_phase(device)
                + auto_phase(hmm, requests, oracles, device) + harness_phase(device))
    print(f"lean, auto and the harness: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def sieve_mirror(name: str, hmm, y) -> np.ndarray:
    """The copied oracle of SIEVE decoder ``name`` at SIEVE_STATIC's
    options: SIEVE-Mp in fp32 numerics, the fp32 SIEVE-BS-Mp mirror, or
    the float64 SIEVE-BS oracle (for a uniform Pi, as the headline's),
    its pairs laid out as the decoder's path."""
    from flash_viterbi_tpu_torch.algorithms.sieve_bs import _flatten_pairs
    from flash_viterbi_tpu_torch.oracle import framework
    from flash_viterbi_tpu_torch.oracle import sieve_bs as osbs
    from flash_viterbi_tpu_torch.oracle.sieve import sieve_mp

    if name == "sieve_mp":
        return sieve_mp(hmm.A, hmm.B, hmm.Pi, y, numerics="f32")
    if name == "sieve_bs":
        require(bool(np.all(hmm.Pi == hmm.Pi[0])), "the SIEVE-BS oracle needs a uniform Pi")
        return _flatten_pairs(osbs.sieve_bs(hmm.A, hmm.B, hmm.Pi, y, **SIEVE_STATIC[name]),
                              len(y))
    return framework.sieve_bs_mp(hmm.A, hmm.B, hmm.Pi, y, **SIEVE_STATIC[name])


def sieve_lane_checks(device) -> None:
    """The scan at every lane count a headline SIEVE level gives (1 to
    T/2 = 128, two steps) and at T=16384's deepest level (8192 lanes, one
    step), at the headline's Kp, against its plain version; masked lanes carry whole
    -inf columns, whose pointer must be 0 (jnp.argmax's)."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    Kp = -(-HEADLINE["K"] // 128) * 128
    g = torch.Generator(device=device).manual_seed(3)
    logA = torch.randn((Kp, Kp), generator=g, device=device)
    logA[:, 9] = float("-inf")
    t0 = time.perf_counter()
    for N, Tm in [(n, 2) for n in range(1, HEADLINE["T"] // 2 + 1)] + [(LONG_T // 2, 1)]:
        emits = torch.randn((Tm, N, Kp), generator=g, device=device)
        emits[:, :, 11] = float("-inf")  # a masked state of every lane
        delta0 = torch.randn((N, Kp), generator=g, device=device)
        got, want = k.maxplus_scan(logA, emits, delta0), km.maxplus_scan_plain(logA, emits,
                                                                               delta0)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"sieve lanes: the scan at N={N} differs from its plain version")
        require(bool((got[1][:, :, 9] == 0).all()), f"N={N}: an all -inf column's pointer")
    print(f"sieve lanes: the scan at N = 1..{HEADLINE['T'] // 2} (T'=2) and N={LONG_T // 2} "
          f"(T'=1), Kp={Kp}, equals its plain version; all -inf columns point at 0 "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def sieve_headline(hmm, requests, oracles, device, witness, name, static):
    """The four requests through ``decode(..., name)`` on ``device``:
    request 0 equals the port's CPU decode (from ``witness``), every ``memory:`` its
    analytic value; prints each path's f64 score beside the C oracle's and
    request 0's peak allocation above the tables beside the analytic
    figure.
    Returns (the launches, request 0's path)."""
    from flash_viterbi_tpu_torch import build, decode
    from flash_viterbi_tpu_torch.oracle.validate import path_score_f64

    K, T = hmm.K, len(requests[0])
    results, launches = drive(f"{name} {static}, {len(requests)} decodes", SIEVE_NEEDS[name],
                              lambda: [decode(hmm, y, name, device=device, **static)
                                       for y in requests])
    only(launches, SIEVE_NEEDS[name])
    dec = build(name, **static)
    want_mem = dec.analytic_memory(K=K, T=T)
    cpu_path, cpu_s = witness.get(name)
    require(np.array_equal(results[0].path, cpu_path),
            f"{name} {static} request 0: {device} path differs from the CPU decode")
    lh = tables(hmm, 128, device)
    for i, (y, r, oracle) in enumerate(zip(requests, results, oracles)):
        require(r.memory_bytes == want_mem,
                f"{name} request {i}: memory {r.memory_bytes} != {want_mem}")
        low = -1 if name == "sieve_bs_mp" else 0
        require(r.path.shape == (T,) and bool(((r.path >= low) & (r.path < K)).all()),
                f"{name} request {i}: path out of range")
        misses = int((r.path == -1).sum())
        score = "n/a (-1 positions)" if misses else repr(
            path_score_f64(hmm.A, hmm.B, hmm.Pi, y, r.path))
        print(f"{name} {static} request {i}: {r.time_s * 1e3:.3f} ms, -1 positions {misses}, "
              f"positions off the C oracle {int((r.path != oracle).sum())}, f64 score "
              f"{score} (the oracle's {path_score_f64(hmm.A, hmm.B, hmm.Pi, y, oracle)!r}), "
              f"memory {r.memory_bytes}, launches {nonzero(r.extra['launches'])}", flush=True)
    _, ms, peak = peak_run(dec, (lh.logA, lh.logB, lh.logPi,
                                 torch.as_tensor(requests[0].astype(np.int64), device=device)),
                           device)
    print(f"{name} {static}: request 0 equals the CPU decode ({cpu_s:.1f} s in the witness); "
          f"its peak +{peak} bytes above the tables ({ms:.3f} ms), the analytic figure "
          f"{want_mem}", flush=True)
    return launches, results[0].path


def sieve_bs_paper_phase(hmm, y, device) -> dict[str, int]:
    """Phase 12d: ``sieve_bs`` at the paper's beam of 32 on request 0
    (``scripts/torch_sieve_bs_witness.py``'s part 1); its sentinels, f64
    score and junction breaks must equal the JAX package's record.  No
    hand kernel may launch.  Returns the launches."""
    from scripts import torch_sieve_bs_witness as paper

    # the paper's own SIEVE-BS run (src/run.py:8-25) is request 0 at a beam of 32
    require(paper.CONFIG == HEADLINE, "the witness script's config is not request 0's")
    label = f"sieve_bs beam_width={paper.BEAM_WIDTH} request 0 (the paper's SIEVE-BS config)"
    (_, steps), launches = drive(label, SIEVE_NEEDS["sieve_bs"],
                                 lambda: paper.decode_steps(hmm, y, device))
    only(launches, SIEVE_NEEDS["sieve_bs"])
    diffs = paper.differences(steps, paper.jax_record())
    require(not diffs, f"{label}: {diffs}")
    dec, score = steps
    print(f"{label}: time_s {dec['wall_s']} s, {dec['elapsed_s']} s with the warmup, -1 "
          f"sentinels {dec['sentinels']}, f64 score {score['score']!r}, junction breaks "
          f"{score['junction_breaks']}: equal to the JAX package's record", flush=True)
    return launches


def device_profile(run, device) -> tuple[float, int, list]:
    """Device busy ms and kernel launches of one ``run()`` by torch.profiler,
    after one profiled run thrown away (a session right after many thousand
    kernels records only part of its own), and the four largest kernels
    (name, ms, launches): (busy, launches, largest).  A kept session that
    recorded no device time at all (seen once among sessions that recorded
    in full before and after it on the H100) is followed by another, up to
    PROFILE_SESSIONS in all.  Host work timed after a profiler session has
    run ~2.3x slower on the H100 machine, so time first."""
    from torch.profiler import ProfilerActivity, profile

    from flash_viterbi_tpu_torch.utils.profiling import device_rows

    for session in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize(device)
        kernels = device_rows(prof)
        if session > 0 and kernels:
            break
    require(bool(kernels), f"the profiler recorded no device time in {PROFILE_SESSIONS - 1} "
            "sessions")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    largest = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
               for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]]
    return busy, sum(e.count for e in kernels), largest


def sieve_bs_checks(hmm, y, device, witness) -> list[dict[str, int]]:
    """``sieve_bs`` (B=64) on the card: the headline's request 0 against the
    port's CPU decode (from ``witness``), ``memory:`` its analytic value;
    its time, device busy and idle share and launches (torch.profiler), its
    peak allocation beside ``memory:``, the tree's nodes and levels, the
    b-hop searches' hops and the host's BFS time; the K=512 mirror fixture
    against the float64 oracle; the beam-of-2 sentinel fixture against the
    fp32 framework mirror.  The decoder has no hand kernel: every phase must
    launch none.  Returns the launches."""
    from flash_viterbi_tpu_torch import build, decode
    from flash_viterbi_tpu_torch.algorithms import sieve_bs as tbs
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm
    from flash_viterbi_tpu_torch.oracle import framework

    name, static, out = "sieve_bs", SIEVE_STATIC["sieve_bs"], []
    t0 = time.perf_counter()
    r, launches = drive(f"{name} {static}, request 0", SIEVE_NEEDS[name],
                        lambda: decode(hmm, y, name, device=device, **static))
    only(launches, SIEVE_NEEDS[name])
    out.append(launches)
    cpu_path, cpu_s = witness.get(name)
    require(np.array_equal(r.path, cpu_path), f"{name} request 0: the card's path differs "
            "from the CPU decode")
    dec = build(name, **static)
    want_mem = dec.analytic_memory(K=hmm.K, T=len(y))
    require(r.memory_bytes == want_mem, f"{name}: memory {r.memory_bytes} != {want_mem}")
    require(bool(((r.path >= -1) & (r.path < hmm.K)).all()), f"{name}: path out of range")
    lh = tables(hmm, 128, device)
    args = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(y.astype(np.int64), device=device))
    _, ms, peak = peak_run(dec, args, device)
    stats = {}
    t1 = time.perf_counter()
    pairs = tbs.sieve_bs_decode(*args[:3], y, static["beam_width"], stats=stats)
    torch.cuda.synchronize(device)
    stats_s = time.perf_counter() - t1
    require(np.array_equal(tbs._flatten_pairs(pairs, len(y)), r.path),
            f"{name}: the counted decode's path differs")
    busy, kernels, largest = device_profile(lambda: dec(*args), device)
    wall = r.time_s * 1e3
    print(f"{name} {static} request 0: time_s {r.time_s:.6f} (the peak's run {ms:.3f} ms by "
          f"CUDA events), equal to the CPU decode ({cpu_s:.1f} s in the "
          f"witness); device busy {busy:.3f} ms, idle {wall - busy:.3f} ms of time_s "
          f"({(wall - busy) / wall * 100:.1f}%), {kernels} kernel launches (torch.profiler; "
          f"no hand kernel); peak +{peak} bytes above the tables against memory: {want_mem}; "
          f"{stats['nodes']} nodes, {stats['levels']} levels, {stats['forward_lanes']} "
          f"forward lanes; b-hop searches stopped after {stats['bhop_hops']} hops (ancestors, "
          f"descendants) of {stats['bhop_limit']}; host BFS "
          f"{stats['host_bfs_s'] * 1e3:.1f} ms of a {stats_s * 1e3:.1f} ms decode; -1 positions {int((r.path == -1).sum())}; largest "
          f"device items: " + "; ".join(f"{k} {t:.3f} ms ({n})" for k, t, n in largest),
          flush=True)

    K = SIEVE_MIRROR_K[name]
    mhmm, my = make_sparse_hmm(**dict(HEADLINE, K=K))
    r, launches = drive(f"{name} K={K} T={len(my)}", SIEVE_NEEDS[name],
                        lambda: decode(mhmm, my, name, device=device, **static))
    only(launches, SIEVE_NEEDS[name])
    out.append(launches)
    want, oracle_s = witness.get(f"mirror_{name}")
    require(np.array_equal(r.path, want), f"{name} K={K}: path differs from the float64 oracle")
    print(f"{name} K={K} T={len(my)}: {r.time_s * 1e3:.3f} ms, equal to the float64 SIEVE-BS "
          f"oracle ({oracle_s:.1f} s in the witness)", flush=True)

    fix, bw = SIEVE_BS_SENTINEL
    shmm, sy = make_sparse_hmm(**fix)
    r, launches = drive(f"{name} beam_width={bw} sentinel fixture", SIEVE_NEEDS[name],
                        lambda: decode(shmm, sy, name, device=device, beam_width=bw))
    only(launches, SIEVE_NEEDS[name])
    out.append(launches)
    pairs = framework.sieve_bs(shmm.A, shmm.B, shmm.Pi, sy, beam_width=bw)
    require((-1, -1) in [tuple(int(v) for v in p) for p in pairs],
            f"{name} sentinel fixture: no (-1, -1) pair")
    require(np.array_equal(r.path, tbs._flatten_pairs(pairs, len(sy))),
            f"{name} sentinel fixture: path differs from the framework mirror")
    print(f"{name} beam_width={bw} {fix}: equal to the fp32 framework mirror, "
          f"{sum(p == (-1, -1) for p in pairs)} (-1, -1) of {len(pairs)} pairs; sieve_bs "
          f"checks {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def sieve_phase(hmm, requests, oracles, device, cpu_device, witness) -> list[dict[str, int]]:
    """The SIEVE decoders: the headline requests (``sieve_mp`` pruned and,
    request 0 only, not; ``sieve_bs_mp`` at B=64), the mirror fixtures
    against the copied oracles, the tie fixture against the CPU decode, the
    scan at every lane count a level gives, and the harness's rows at the
    mirror fixtures.  Prints the phase's wall time; returns the launches."""
    import csv

    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.bench.harness import CSV_FIELDS, RunConfig, sweep
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, make_tie_hmm

    t_phase = time.perf_counter()
    print(f"sieve phase: {spin_up(device)}", flush=True)
    (mp_launches, pruned), (bs_launches, _) = (
        sieve_headline(hmm, requests, oracles, device, witness, name, SIEVE_STATIC[name])
        for name in ("sieve_mp", "sieve_bs_mp"))
    all_launches = [mp_launches, bs_launches]
    r, launches = drive("sieve_mp prune=False, request 0", SIEVE_NEEDS["sieve_mp"],
                        lambda: decode(hmm, requests[0], "sieve_mp", prune=False,
                                       device=device))
    all_launches.append(launches)
    cpu_path, cpu_s = witness.get("sieve_mp_unpruned")
    require(np.array_equal(r.path, cpu_path), "sieve_mp prune=False: path differs from the "
            "CPU decode")
    print(f"sieve_mp prune=False request 0: {r.time_s * 1e3:.3f} ms, equal to the CPU decode "
          f"({cpu_s:.1f} s in the witness); positions off the pruned path "
          f"{int((r.path != pruned).sum())}", flush=True)

    configs = []
    tie_hmm, tie_y = make_tie_hmm(K=300, M=3, T=64, prob=8 / 300, seed=11)
    for name in ("sieve_mp", "sieve_bs_mp"):
        K, static = SIEVE_MIRROR_K[name], SIEVE_STATIC[name]
        fix = dict(HEADLINE, K=K)
        prob, y = make_sparse_hmm(**fix)
        r, launches = drive(f"{name} K={K} T={len(y)}", SIEVE_NEEDS[name],
                            lambda: decode(prob, y, name, device=device, **static))
        all_launches.append(launches)
        want, oracle_s = witness.get(f"mirror_{name}")
        require(np.array_equal(r.path, want), f"{name} K={K}: path differs from its oracle")
        print(f"{name} K={K} T={len(y)}: {r.time_s * 1e3:.3f} ms, equal to its oracle "
              f"({oracle_s:.1f} s in the witness)", flush=True)
        configs.append(RunConfig(algorithm=name, device=str(device),
                                 beam_width=static.get("beam_width"), **fix))
        r, launches = drive(f"{name} tie fixture", SIEVE_NEEDS[name],
                            lambda: decode(tie_hmm, tie_y, name, device=device, **static))
        all_launches.append(launches)
        cpu = decode(tie_hmm, tie_y, name, device=cpu_device, warmup=False, **static)
        require(np.array_equal(r.path, cpu.path), f"{name} tie fixture: path differs from the "
                "CPU decode")
        require(np.array_equal(r.path, sieve_mirror(name, tie_hmm, tie_y)),
                f"{name} tie fixture: path differs from its oracle")
        print(f"{name} tie fixture (K={tie_hmm.K}, T={len(tie_y)}): equal to the CPU decode "
              f"and the oracle", flush=True)
    sieve_lane_checks(device)
    all_launches += sieve_bs_checks(hmm, requests[0], device, witness)
    with tempfile.TemporaryDirectory() as csv_dir:
        rows, launches = drive("sieve harness sweep", ("maxplus_scan", "fold_planes"),
                               lambda: sweep(configs, csv_dir=csv_dir))
        all_launches.append(launches)
        for name in sorted(os.listdir(csv_dir)):
            with open(os.path.join(csv_dir, name)) as f:
                header = next(csv.reader(f))
            require(header == CSV_FIELDS, f"{name}: header {header}")
    for cfg, row in zip(configs, rows):
        require(row["parity"] is True, f"harness {cfg.algorithm}: parity {row['parity']!r}")
        print("harness row: " + ",".join(str(row[k]) for k in CSV_FIELDS), flush=True)
    print(f"sieve phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return all_launches


def dyn_reference(key: str, outdir: str) -> np.ndarray:
    """Make DYN_FIXTURES[key]'s problem, save its tables and observations as
    ``<key>_tables.npz`` in ``outdir`` and return the path the card's is
    held to: the port's CPU decode, the float64 SIEVE / SIEVE-DAG oracle's
    pairs laid out as the decoder's path, or (None) an empty array."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.algorithms.sieve_bs import _flatten_pairs
    from flash_viterbi_tpu_torch.models.generate import make_dag_hmm, make_sparse_hmm
    from flash_viterbi_tpu_torch.oracle.sieve import sieve_dag, sieve_dynamic

    name, problem, kind = DYN_FIXTURES[key]
    if name == "sieve_dag":
        hmm, y = make_dag_hmm(**problem, sanitize=True)
    else:
        hmm, y = make_sparse_hmm(**problem)
    np.savez(os.path.join(outdir, f"{key}_tables.npz"), A=hmm.A, B=hmm.B, Pi=hmm.Pi, y=y)
    if kind == "cpu":
        return decode(hmm, y, name, device="cpu", warmup=False).path
    if kind == "oracle":
        oracle = sieve_dag if name == "sieve_dag" else sieve_dynamic
        return _flatten_pairs(oracle(hmm.A, hmm.B, hmm.Pi, y), len(y))
    return np.zeros(0, dtype=np.int32)


def sieve_dyn_checks(name: str, hmm, y, device, warmup: bool) -> tuple:
    """``name`` (``sieve`` or ``sieve_dag``, no hand kernel: none may launch)
    on ``(hmm, y)`` on the card, held by invariants: every pair an edge of
    A, the path the pairs' layout, ``memory:`` its analytic value, and a
    second run on the card equal to the first.  Prints the decode's time,
    its peak allocation above the tables beside ``memory:``, the tree's
    nodes, levels, forward lanes and node-steps, and the device ms of the
    counts and of the children's searches.  Returns (the launches, the
    decode's result)."""
    from flash_viterbi_tpu_torch import build, decode
    from flash_viterbi_tpu_torch.algorithms import sieve_dyn

    T = len(y)
    r, launches = drive(f"{name} K={hmm.K} T={T}", (),
                        lambda: decode(hmm, y, name, device=device, warmup=warmup))
    only(launches, ())
    want_mem = build(name).analytic_memory(K=hmm.K, T=T)
    require(r.memory_bytes == want_mem, f"{name}: memory {r.memory_bytes} != {want_mem}")
    lh = tables(hmm, 128, device)
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    stats = {}
    t0 = time.perf_counter()
    pairs = sieve_dyn.sieve_dynamic_decode(lh.logA, lh.logB, lh.logPi, y,
                                           dag=name == "sieve_dag", stats=stats)
    counted_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - before
    path = sieve_dyn._flatten_pairs(pairs, T)
    require(np.array_equal(path, r.path), f"{name}: two runs on the card differ")
    require(bool(pairs) and len(pairs) < T, f"{name}: {len(pairs)} pairs for T={T}")
    require(all(hmm.A[a, b] > 0 for a, b in pairs), f"{name}: a pair is not an edge of A")
    n = len(pairs) + 1
    require(bool(((path[:n] >= 0) & (path[:n] < hmm.K)).all()) and bool((path[n:] == -1).all()),
            f"{name}: the path is not its pairs' layout")
    print(f"{name} K={hmm.K} (Kp {lh.Kp}) T={T}: time_s {r.time_s:.6f} "
          f"({'after a warmup' if warmup else 'no warmup'}), a second run equal "
          f"({counted_s:.3f} s with its counters); peak +{peak} bytes above the tables against "
          f"memory: {want_mem}; {stats['nodes']} nodes, {stats['levels']} levels, "
          f"{stats['forward_lanes']} forward lanes, {stats['node_steps']} node-steps; counts "
          f"{stats['count_ms']:.3f} ms (b-hop searches {stats['bhop_hops']} hops), children's "
          f"searches {stats['bfs_ms']:.3f} ms on the device; {len(pairs)} pairs, each an edge "
          f"of A", flush=True)
    return launches, r


def profile_line(label: str, name: str, hmm, y, wall_ms: float, device) -> None:
    """Print the device busy ms, idle share of ``wall_ms`` and kernel
    launches of one decode of ``name`` on ``(hmm, y)`` (torch.profiler)."""
    from flash_viterbi_tpu_torch import build

    lh = tables(hmm, 128, device)
    args = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(y.astype(np.int64), device=device))
    busy, kernels, largest = device_profile(lambda: build(name)(*args), device)
    print(f"{label}: device busy {busy:.3f} ms, idle {wall_ms - busy:.3f} ms of {wall_ms:.3f} "
          f"({(wall_ms - busy) / wall_ms * 100:.1f}%), {kernels} kernel launches "
          f"(torch.profiler; no hand kernel); largest device items: "
          + "; ".join(f"{k} {t:.3f} ms ({c})" for k, t, c in largest), flush=True)


def sieve_dyn_phase(hmm, requests, device, witness) -> list[dict[str, int]]:
    """``sieve`` on the headline's request 0 (held by invariants; one
    decode, no warmup: ~15 s), its first SIEVE_DYN_PREFIX symbols against
    the port's CPU decode, and DYN_FIXTURES' sieve fixture against the
    float64 oracle; ``sieve_dag`` on DYN_FIXTURES' K=4096 DAG (held by
    invariants) and its smaller DAGs against the CPU decode and the float64
    oracle.  Last, the profiles of the prefix and of the K=4096 decode.
    Prints the phase's wall time; returns the launches."""
    from flash_viterbi_tpu_torch import decode

    t_phase = time.perf_counter()
    print(f"dynamic SIEVE phase: {spin_up(device)}", flush=True)
    launches, _ = sieve_dyn_checks("sieve", hmm, requests[0], device, warmup=False)
    out = [launches]
    y = requests[0][:SIEVE_DYN_PREFIX]
    prefix, launches = drive(f"sieve T={len(y)}", (),
                             lambda: decode(hmm, y, "sieve", device=device))
    only(launches, ())
    out.append(launches)
    want, secs = witness.get("sieve_prefix")
    require(np.array_equal(prefix.path, want),
            f"sieve T={len(y)}: path differs from the CPU decode")
    print(f"sieve K={hmm.K} T={len(y)} (request 0's first symbols): {prefix.time_s * 1e3:.3f} "
          f"ms, equal to the CPU decode ({secs:.1f} s in the witness)", flush=True)
    dag_hmm, dag_y = witness.problem("dag_large")
    launches, dag = sieve_dyn_checks("sieve_dag", dag_hmm, dag_y, device, warmup=True)
    out.append(launches)
    for key, (name, problem, kind) in DYN_FIXTURES.items():
        if kind is None:
            continue
        fhmm, fy = witness.problem(key)
        r, launches = drive(f"{name} {problem}", (),
                            lambda: decode(fhmm, fy, name, device=device, warmup=False))
        only(launches, ())
        out.append(launches)
        want, secs = witness.get(key)
        what = "CPU decode" if kind == "cpu" else "float64 oracle"
        require(np.array_equal(r.path, want), f"{name} {problem}: path differs from the {what}")
        print(f"{name} K={problem['K']} T={problem['T']}: {r.time_s * 1e3:.3f} ms (no warmup), "
              f"equal to the {what} ({secs:.1f} s in the witness)", flush=True)
    profile_line(f"sieve K={hmm.K} T={len(y)}", "sieve", hmm, y, prefix.time_s * 1e3, device)
    profile_line(f"sieve_dag K={dag_hmm.K} T={len(dag_y)}", "sieve_dag", dag_hmm, dag_y,
                 dag.time_s * 1e3, device)
    print(f"dynamic SIEVE phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def flash_long_phase(hmm, requests, oracles, device) -> list[dict[str, int]]:
    """The four requests through ``decode(..., "flash_long", num_segments=4)``:
    each path equals flash pointer mode's at 4 segments on the card and the C
    oracle under phase 4's rule; ``memory:`` flash's at 4 segments.  Then
    T=16384 on the headline tables at every group size of LONG_GROUPS:
    equal to flash pointer mode's path, each one's time and peak above the
    tables printed.  Returns the launches."""
    from flash_viterbi_tpu_torch import build, decode
    from flash_viterbi_tpu_torch.algorithms.flash import _memory
    from flash_viterbi_tpu_torch.models.generate import observations

    K, T = hmm.K, len(requests[0])
    results, launches = drive(
        f"flash_long num_segments={LONG_SEGMENTS}, {len(requests)} decodes", LONG_NEEDS,
        lambda: [decode(hmm, y, "flash_long", num_segments=LONG_SEGMENTS, device=device)
                 for y in requests])
    only(launches, LONG_NEEDS)
    want_mem = _memory(K=K, T=T, num_segments=LONG_SEGMENTS)
    for i, (y, r, oracle) in enumerate(zip(requests, results, oracles)):
        flash = decode(hmm, y, "flash", num_segments=LONG_SEGMENTS, device=device)
        require(np.array_equal(r.path, flash.path),
                f"flash_long request {i}: path differs from flash pointer mode")
        require(r.memory_bytes == want_mem, f"flash_long request {i}: memory {r.memory_bytes}")
        verdict = oracle_verdict(hmm, y, r.path, oracle, exact=i == 0)
        print(f"flash_long request {i}: {r.time_s * 1e3:.3f} ms (flash at {LONG_SEGMENTS} "
              f"segments {flash.time_s * 1e3:.3f} ms), equal to flash pointer mode, oracle "
              f"{verdict}, memory {r.memory_bytes}, launches {nonzero(r.extra['launches'])}",
              flush=True)

    lh = tables(hmm, 128, device)
    y = observations(LONG_T, HEADLINE["M"], seed=1)
    args = (lh.logA, lh.logB, lh.logPi, torch.as_tensor(y.astype(np.int64), device=device))
    want, flash_ms, flash_peak = peak_run(build("flash", num_segments=LONG_SEGMENTS), args,
                                          device)
    rows = {}

    def run():
        for g in LONG_GROUPS:
            rows[g] = peak_run(build("flash_long", num_segments=LONG_SEGMENTS, group_steps=g),
                               args, device)

    _, long_launches = drive(f"flash_long T={LONG_T}", LONG_NEEDS, run)
    only(long_launches, LONG_NEEDS)
    for g, (path, ms, peak) in rows.items():
        require(torch.equal(path, want), f"flash_long T={LONG_T} group_steps={g}: path "
                "differs from flash pointer mode")
    print(f"flash_long T={LONG_T}, Kp={lh.Kp}, {LONG_SEGMENTS} segments, equal to flash "
          f"pointer mode ({flash_ms:.3f} ms, peak +{flash_peak} bytes) at every group size: "
          + "; ".join(f"group_steps={g} {ms:.3f} ms, peak +{peak} bytes "
                      f"({peak / 2**20:.1f} MiB)" for g, (_, ms, peak) in rows.items()),
          flush=True)
    return [launches, long_launches]


def route_of(launches: dict) -> str:
    """The fused route whose two kernels launched, and only they."""
    took = [r for r, names in ROUTE_KERNELS.items() if all(launches[n] for n in names)]
    other = [n for r, names in ROUTE_KERNELS.items() if r not in took for n in names]
    require(len(took) == 1 and not any(launches[n] for n in other),
            f"no single fused route launched: {nonzero(launches)}")
    return took[0]


def routes_phase(device) -> list[dict[str, int]]:
    """Phase 8f: each routing rule on the two sides of its thresholds.
    ``decode(..., "fused")`` at ROUTE_SINGLE, ``decode_batch(..., "fused")``
    at ROUTE_BATCH and ``decode(..., "checkpoint")`` at ROUTE_SNAPSHOT on
    the card: the launches show the route ``fused.pointer_route`` names
    (both routes among the sides of each), and the snapshot step's chunks
    (two gather scans and a walk each); every path equals the port's CPU
    decode.  Then both routes (both steps) of each in turns (a, b, b, a,
    ``scripts/torch_route_sweep.py``'s ``in_turns``), their medians
    printed under the card's name and power limit.  Returns the launches."""
    import functools

    from flash_viterbi_tpu_torch import decode, decode_batch
    from flash_viterbi_tpu_torch.algorithms import checkpoint, fused
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, observations
    from scripts.torch_route_sweep import card_line, in_turns

    t0 = time.perf_counter()
    print(f"routes phase: {card_line()}; {spin_up(device)}", flush=True)
    cpu = torch.device("cpu")
    made = {}

    def problem(K, T, Bs=1):
        if K not in made:
            made[K] = make_sparse_hmm(K=K, M=HEADLINE["M"], T=2, prob=HEADLINE["prob"],
                                      seed=1)[0]
        ys = np.stack([observations(T, HEADLINE["M"], seed=s) for s in range(1, Bs + 1)])
        return made[K], ys

    def turns(label, runs):
        timed = in_turns(runs, device)
        print(f"{label}, in turns: " + ", ".join(
            f"{name} {statistics.median(t[0] + t[1]):.3f} ms" for name, (t, _) in timed.items()),
            flush=True)

    def forced(lh, ys, pointers):
        yd = torch.as_tensor(ys.astype(np.int64), device=device)
        if len(ys) > 1:
            return lambda: fused.fused_decode_batch(lh.logA, lh.logB, lh.logPi, yd,
                                                    pointers=pointers)
        emits = lh.logB.t()[yd[0]]
        return lambda: fused._walk(lh.logA, emits[1:].unsqueeze(1),
                                   (lh.logPi + emits[0])[None, :], pointers)

    all_launches, seen = [], {"single": set(), "batch": set()}
    for kind, cases in (("single", [(K, T, 1) for K, T in ROUTE_SINGLE]),
                        ("batch", ROUTE_BATCH)):
        for K, T, Bs in cases:
            hmm, ys = problem(K, T, Bs)
            label = f"routes: fused K={K} T={T}" + (f" Bs={Bs}" if kind == "batch" else "")
            if kind == "single":
                r, launches = drive(label, (), lambda: decode(hmm, ys[0], "fused", device=device))
                want = decode(hmm, ys[0], "fused", device=cpu, warmup=False).path
            else:
                r, launches = drive(label, (), lambda: decode_batch(hmm, ys, "fused",
                                                                    device=device))
                want = decode_batch(hmm, ys, "fused", device=cpu, warmup=False).path
            all_launches.append(launches)
            Kp = -(-K // 128) * 128
            rule = fused.pointer_route(Kp, Bs)
            took = route_of(launches)
            require(took == rule, f"{label}: took {took}, the rule names {rule}")
            require(np.array_equal(r.path, want.reshape(r.path.shape)),
                    f"{label}: path differs from the port's CPU decode")
            seen[kind].add(rule)
            lh = tables(hmm, 128, device)
            turns(f"{label} ({rule}, equal to the CPU decode)",
                  {p: forced(lh, ys, p) for p in ROUTE_KERNELS})
    require(all(v == set(ROUTE_KERNELS) for v in seen.values()),
            f"routes: the sides do not reach both routes: {seen}")

    K, T, old = ROUTE_SNAPSHOT
    hmm, ys = problem(K, T)
    step = checkpoint.snapshot_step(T)
    chunks = len(range(0, T - 1, step))
    r, launches = drive(f"routes: checkpoint K={K} T={T}",
                        ("maxplus_scan_emitgather", "backtrack_batched"),
                        lambda: decode(hmm, ys[0], "checkpoint", device=device))
    all_launches.append(launches)
    require(launches["maxplus_scan_emitgather"] == 4 * chunks
            and launches["backtrack_batched"] == 2 * chunks,
            f"checkpoint K={K} T={T}: {nonzero(launches)} for step {step} ({chunks} chunks, "
            "a warmup and a timed decode)")
    want = decode(hmm, ys[0], "checkpoint", device=cpu, warmup=False).path
    require(np.array_equal(r.path, want), f"checkpoint K={K} T={T}: path differs from the "
            "port's CPU decode")
    lh = tables(hmm, 128, device)
    yd = torch.as_tensor(ys[0].astype(np.int64), device=device)
    turns(f"routes: checkpoint K={K} T={T}, step {step} ({chunks} chunks, equal to the CPU "
          f"decode) against {old}",
          {f"step={s}": functools.partial(checkpoint.checkpoint_decode, lh.logA, lh.logB,
                                          lh.logPi, yd, step=s) for s in (step, old)})
    print(f"routes phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return all_launches


def captured(fn, *args):
    """(``fn(*args)``, what it wrote to standard output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def cli_run(argv: list[str]) -> str:
    """``cli.main(argv)`` in this process (its launches count); its output,
    after it returned 0."""
    from flash_viterbi_tpu_torch import cli

    rc, text = captured(cli.main, argv)
    require(rc == 0, f"cli {argv[0]}: exit code {rc}: {text[-2000:]}")
    return text


def reference_stdout(text: str) -> tuple[float, np.ndarray, int]:
    """(time, path, memory) of the reference stdout protocol."""
    m = re.fullmatch(r"time: (\S+) \npath: \[([^\]]*)\]\nmemory: (\d+)\n", text)
    require(m is not None, f"not the reference stdout protocol: {text[:300]!r}")
    return float(m.group(1)), np.array(m.group(2).split(), dtype=np.int64), int(m.group(3))


def ans_paths(text: str) -> dict[str, np.ndarray]:
    """Each decoder's path in a ``compare`` summary file."""
    paths, name = {}, None
    for line in text.splitlines():
        if " Time: " in line:
            name = line.split(" Time: ")[0]
        elif line.startswith("path: "):
            paths[name] = np.array(ast.literal_eval(line[len("path: "):]))
    return paths


def tools_phase(hmm, requests, oracles, device, witness, beam_paths) -> dict[str, int]:
    """The command line, the headline script and the tools on the card at
    the headline: ``cli decode`` (fused) against request 0's C oracle and
    fused's analytic memory; ``generate`` then ``decode --data`` at
    K=TOOLS_DATA_K against the C oracle of the files; ``bench -a
    fused,flash`` (parity, CSV header); ``compare`` in a temporary
    directory (the exact decoders against the C oracle, ``flash_bs`` and
    ``beam`` against the beam phase's paths, ``sieve_mp`` against the CPU
    decode, the SIEVE oracles skipped); the headline script (exact parity);
    ``scaling --measure`` on TOOLS_MESHES (every row's paths equal) beside
    ``single_chip_wall_model``; ``profile_flash``; ``memory_report`` after
    a decode; ``decode(..., retries=2)``.  Prints the phase's seconds;
    returns the launches."""
    import csv

    from flash_viterbi_tpu_torch import build, decode
    from flash_viterbi_tpu_torch.algorithms import fused
    from flash_viterbi_tpu_torch.bench import headline as headline_script
    from flash_viterbi_tpu_torch.bench.harness import CSV_FIELDS
    from flash_viterbi_tpu_torch.oracle import native
    from flash_viterbi_tpu_torch.parallel import scaling
    from flash_viterbi_tpu_torch.utils.io import load_dataset
    from flash_viterbi_tpu_torch.utils.profiling import memory_report, profile_flash

    t_phase = time.perf_counter()
    K, T, y1 = hmm.K, HEADLINE["T"], requests[0]
    problem = ["-K", str(K), "-M", str(HEADLINE["M"]), "-T", str(T), "-p",
               str(HEADLINE["prob"]), "-s", str(HEADLINE["seed"])]
    small = ["-K", str(TOOLS_DATA_K)] + problem[2:]
    out = {}

    def run():
        out["decode"] = reference_stdout(cli_run(["decode", "-a", "fused", *problem]))
        with tempfile.TemporaryDirectory() as data:
            cli_run(["generate", *small, "-o", data])
            out["data"] = reference_stdout(cli_run(["decode", "-a", "fused", *small,
                                                    "--data", data]))
            out["data_hmm"] = load_dataset(data, TOOLS_DATA_K, T, HEADLINE["M"],
                                           prob=HEADLINE["prob"])
        with tempfile.TemporaryDirectory() as csv_dir:
            out["bench"] = cli_run(["bench", "-a", "fused,flash", *problem,
                                    "--csv-dir", csv_dir])
            out["csv"] = {}
            for name in ("fused", "flash"):
                with open(os.path.join(csv_dir, f"{name}.csv")) as f:
                    out["csv"][name] = list(csv.reader(f))
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as work:
            os.chdir(work)
            try:
                out["compare"] = cli_run(["compare", *problem])
                ans = f"ANS_K{K}_T{T}_prob{HEADLINE['prob']}_beam_width{BEAM_WIDTH}.txt"
                with open(ans) as f:
                    out["ans"] = f.read()
            finally:
                os.chdir(cwd)
        out["headline"] = captured(headline_script.main, [])
        out["scaling"] = cli_run(["scaling", "--mesh", TOOLS_MESHES, "--measure"])
        out["profile"] = profile_flash(hmm, y1, num_segments=SEGMENTS, device=device)
        r = decode(hmm, y1, "fused", device=device)
        out["memory"] = memory_report(build("fused"), K=K, T=T, device=device)
        out["retries"] = (r, decode(hmm, y1, "fused", retries=2, device=device))

    _, launches = drive("command line and tools", TOOLS_NEEDS, run)

    secs, path, mem = out["decode"]
    verdict = oracle_verdict(hmm, y1, path, oracles[0], exact=True)
    require(mem == fused._memory(K=K, T=T), f"cli decode: memory {mem}")
    rate = K * K * (T - 1) / secs
    print(f"cli decode -a fused at the headline: time {secs:.6f} s, oracle {verdict}, "
          f"memory {mem}; (T-1)K^2 / time = {rate:.4g} updates/s against "
          f"CHIP_UPDATES_PER_S {scaling.CHIP_UPDATES_PER_S:.4g}; single_chip_wall_model"
          f"({K}, {T}) {scaling.single_chip_wall_model(K, T) * 1e3:.3f} ms against "
          f"{secs * 1e3:.3f} ms measured", flush=True)

    dhmm, dy = out["data_hmm"]
    want = native.vanilla(dhmm.A, dhmm.B, dhmm.Pi, dy)
    require(np.array_equal(out["data"][1], want),
            f"cli decode --data K={TOOLS_DATA_K}: path differs from the C oracle")
    print(f"cli generate + decode --data K={TOOLS_DATA_K}: equal to the C oracle of the "
          f"files, time {out['data'][0]:.6f} s, memory {out['data'][2]}", flush=True)

    for name, rows in out["csv"].items():
        require(rows[0] == CSV_FIELDS, f"cli bench {name}.csv: header {rows[0]}")
        require(len(rows) == 2, f"cli bench {name}.csv: {len(rows) - 1} rows")
        row = dict(zip(rows[0], rows[1]))
        require(row["parity"] in ("True", "mirror-exact", "tie-equivalent"),
                f"cli bench {name}: parity {row['parity']!r}")
        print(f"cli bench row: {','.join(rows[1])}", flush=True)

    ans = out["ans"]
    paths = ans_paths(ans)
    require("SIEVE oracles skipped" in ans and "(oracle)" not in ans,
            "cli compare: the SIEVE oracles were not skipped at the headline")
    require(sorted(paths) == sorted(("vanilla", "checkpoint", "fused", "flash", "flash_bs",
                                     "sieve_mp", "beam")), f"cli compare: rows {sorted(paths)}")
    verdicts = {name: oracle_verdict(hmm, y1, paths[name], oracles[0],
                                     exact=name != "flash")
                for name in ("vanilla", "checkpoint", "fused", "flash")}
    for name in ("flash_bs", "beam"):
        require(np.array_equal(paths[name], beam_paths[name]),
                f"cli compare {name}: path differs from the beam phase's")
    require(np.array_equal(paths["sieve_mp"], witness.get("sieve_mp")[0]),
            "cli compare sieve_mp: path differs from the CPU decode")
    print(f"cli compare at the headline: {verdicts}; flash_bs and beam equal the beam "
          f"phase's paths, sieve_mp the CPU decode; SIEVE oracles skipped; its lines: "
          f"{' | '.join(out['compare'].splitlines())}", flush=True)

    row, text = out["headline"]
    require(row["exact_path_parity"] is True, f"headline script: {text}")
    require(set(BENCH_KEYS) <= set(row), f"headline script: keys {sorted(row)}")
    print(f"headline script: {text.strip()}", flush=True)

    lines = out["scaling"].splitlines()
    modeled = [json.loads(line) for line in lines if line.startswith('{"')]
    measured = [ast.literal_eval(line) for line in lines if line.startswith("{'")]
    require(len(modeled) == len(measured) == len(TOOLS_MESHES.split(";")),
            f"cli scaling: {out['scaling']}")
    require(all(r["paths_equal"] for r in measured), f"cli scaling: {measured}")
    for m, r in zip(modeled, measured):
        print(f"cli scaling {r['shape']}: paths_equal {r['paths_equal']}, work_balance "
              f"{r['work_balance']:.4f}, modeled_efficiency at K={m['K']} T={m['T']} "
              f"batch {m['batch']} {m['modeled_efficiency']:.4f}", flush=True)

    prof = out["profile"]
    require(0 < prof["phase1_s"] <= prof["total_s"], f"profile_flash: {prof}")
    print(f"profile_flash N={SEGMENTS}: {prof}", flush=True)

    mem = out["memory"]
    require(mem["analytic_bytes"] == fused._memory(K=K, T=T)
            and 0 < mem["live_array_bytes"] == mem["device_bytes_in_use"]
            <= mem["device_peak_bytes_in_use"] <= mem["device_bytes_limit"],
            f"memory_report: {mem}")
    print(f"memory_report after a fused decode: {mem}", flush=True)

    plain, retried = out["retries"]
    require(np.array_equal(plain.path, retried.path), "decode(..., retries=2): path differs")
    print(f"decode fused retries=2: equal path, {retried.time_s * 1e3:.3f} ms (without "
          f"{plain.time_s * 1e3:.3f} ms)", flush=True)
    print(f"command line and tools phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def bf16_tie_fixture(device, K: int = 1000, N: int = 20, Tm: int = 21, seed: int = 9):
    """A dense-tie bf16 table: four distinct values, an all -inf source row
    and destination column; integer emissions and carries, a ragged valid
    mask.  K is not a multiple of 8 and N needs two lane groups."""
    rng = np.random.default_rng(seed)
    logA = rng.choice(np.float32([-3.0, -1.5, -0.75, 0.0]), (K, K))
    logA[K // 3] = -np.inf
    logA[:, K // 5] = -np.inf

    def put(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    ties = (put(logA).to(torch.bfloat16), put(np.round(rng.standard_normal((Tm, N, K)))),
            put(np.round(rng.standard_normal((N, K)))))
    return ties, torch.as_tensor(rng.random((Tm, N)) < 0.8, device=device)


def bf16_check_all(scan_in, deltas_in, valid, device, reps: int = 0) -> list[dict]:
    """The three bf16 instances against their plain versions: the pointer
    scan on ``scan_in``, the deltas scan on ``deltas_in`` and the walk over
    its carry history (``valid`` its mask), ``logA`` bf16 in both."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops import maxplus as mp
    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    recs = [compare(BF16_SCAN, k.maxplus_scan_bf16, km.maxplus_scan_plain, scan_in, device,
                    reps),
            compare(BF16_DELTAS, k.maxplus_scan_deltas_bf16, km.maxplus_scan_deltas_plain,
                    deltas_in, device, reps)]
    dfin, deltas = k.maxplus_scan_deltas_bf16(*deltas_in)
    logAT = deltas_in[0].t().contiguous()
    recs.append(compare(BF16_WALK, shared_word(k.argmax_walk_bf16, device), kb.argmax_walk_plain,
                        (deltas, logAT, mp.first_argmax(dfin, 1)[1], valid), device, reps))
    return recs


def bf16_kernel_checks(hmm, y, device) -> dict[str, dict]:
    """The bf16 pointer scan, deltas scan and walk against their plain
    versions on the card, bit for bit: at the flash decode's shapes (the
    scans timed at N=1, T'=255 and N=16, T'=16, the walk at the latter's 16
    ragged lanes), the walk also at N=1, T'=255; at the unpadded K=3965; on
    the dense-tie table; on the parity grid GRID_K x GRID_N (the walk over
    each deltas scan's history).  Returns per-kernel records as the kernel
    phase's."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.ops import maxplus as mp
    from flash_viterbi_tpu_torch.ops.cuda import backtrack as kb
    from flash_viterbi_tpu_torch.ops.cuda import maxplus as km

    def bf16(inputs):
        return (inputs[0].to(torch.bfloat16), *inputs[1:])

    t0 = time.perf_counter()
    head = tables(hmm, 128, device)
    scan_in, deltas_in, valid = phase_inputs(head, y, device, seed=0)
    timed = bf16_check_all(bf16(scan_in), bf16(deltas_in), valid, device, reps=9)
    dfin, deltas = k.maxplus_scan_deltas_bf16(*bf16(scan_in))
    long_walk = compare(BF16_WALK, shared_word(k.argmax_walk_bf16, device), kb.argmax_walk_plain,
                        (deltas, bf16(scan_in)[0].t().contiguous(),
                         mp.first_argmax(dfin, 1)[1], None), device, reps=9)
    scan_in, deltas_in, valid = phase_inputs(tables(hmm, 1, device), y, device, seed=1)
    others = [long_walk] + bf16_check_all(bf16(scan_in), bf16(deltas_in), valid, device)
    ties, tie_valid = bf16_tie_fixture(device)
    others += bf16_check_all(ties, ties, tie_valid, device)
    for K in GRID_K:
        for N in GRID_N:
            Tm = GRID_TM_LARGE if K > 4096 else GRID_TM
            grid = bf16(grid_inputs(K, N, Tm, device, seed=K + N + 1)[:3])
            others += bf16_check_all(grid, grid, None, device)
            del grid
        torch.cuda.empty_cache()
    recs = {r["name"]: dict(r, fixtures=1) for r in timed}
    for r in others:
        recs[r["name"]]["max_abs_err"] = max(recs[r["name"]]["max_abs_err"], r["max_abs_err"])
        recs[r["name"]]["fixtures"] += 1
    for name, r in recs.items():
        print(f"kernel {name}: bit-exact on {r['fixtures']} fixtures; {r['ms']:.3f} ms (plain "
              f"{r['plain_ms']:.3f} ms) at the headline shape; bound {r['bound_ms']:.6f} ms by "
              f"{r['bound_by']} ({r['bytes']} bytes, {r['operations']} operations)", flush=True)
    print(f"{BF16_WALK} at N=1, T'={len(y) - 1}: {long_walk['ms']:.4f} ms (plain "
          f"{long_walk['plain_ms']:.3f}); bound {long_walk['bound_ms']:.6f} ms by "
          f"{long_walk['bound_by']}; the bf16 kernel checks {time.perf_counter() - t0:.1f} s",
          flush=True)
    km.raise_on_error(SHARED_ERR, "bf16 kernel checks")
    return recs


def bf16_turns(hmm, y, device) -> None:
    """fp32 against bf16 in turns (fp32, bf16, bf16, fp32) at the headline:
    the phase-1 pointer scan (N=1, T'=255) and phase 2's deltas scan (N=16,
    T'=16) as µs a step, then the fused, flash N=16, lean and recompute
    Bs=16 decodes (the decoders built once, called on the tables on the
    card: the median of 5 CUDA-event timings a turn), and the flash
    decoder's kept tables and peak (``kept_tables``).  Each decode's device
    busy ms is read in the fresh process of phase 13 (``bf16_busy``)."""
    from flash_viterbi_tpu_torch.ops import cuda as k

    head = tables(hmm, 128, device)
    scan_in, deltas_in, _ = phase_inputs(head, y, device, seed=0)
    logA = {"fp32": head.logA, "bf16": head.logA.to(torch.bfloat16)}
    order = ("fp32", "bf16", "bf16", "fp32")
    for label, fn, args in (("pointer scan N=1", k.maxplus_scan, scan_in),
                            ("deltas scan N=16", k.maxplus_scan_deltas, deltas_in)):
        runs = {"fp32": [], "bf16": []}
        for p in order:
            runs[p].append(elapsed_ms(lambda: fn(logA[p], *args[1:]), device, 9))
        steps = args[1].shape[0]
        fp, bf = (statistics.mean(runs[p]) for p in ("fp32", "bf16"))
        print(f"bf16 turns, {label}, T'={steps}: fp32 {fp:.4f} ms ({fp / steps * 1e3:.3f} us a "
              f"step), bf16 {bf:.4f} ms ({bf / steps * 1e3:.3f} us a step), bf16/fp32 "
              f"{bf / fp:.3f}; runs {runs}", flush=True)
    cases = bf16_cases(head, y, device)
    for label in dict.fromkeys(label for label, _ in cases):
        runs = {"fp32": [], "bf16": []}
        for p in order:
            runs[p].append(elapsed_ms(cases[(label, p)], device, 5))
        fp, bf = (statistics.mean(runs[p]) for p in ("fp32", "bf16"))
        print(f"bf16 turns, {label} decode: fp32 {fp:.3f} ms, bf16 {bf:.3f} ms (bf16/fp32 "
              f"{bf / fp:.3f}); runs {runs}", flush=True)
    yd = torch.as_tensor(y.astype(np.int64), device=device)
    for p in ("fp32", "bf16"):
        kept, first, again = kept_tables(head, yd, p, device)
        print(f"flash N={SEGMENTS} {p}: the decoder keeps {kept} bytes of tables across calls; "
              f"the first call's peak +{first} bytes, a later call's +{again} bytes above them",
              flush=True)


def bf16_cases(head, y, device) -> dict:
    """The fused, flash N=16, lean and recompute Bs=16 decodes on the
    headline tables ``head`` at each precision, the decoders built once,
    keyed (label, precision); each called once."""
    import functools

    from flash_viterbi_tpu_torch import build
    from flash_viterbi_tpu_torch.algorithms.fused import fused_decode_batch

    yd = torch.as_tensor(y.astype(np.int64), device=device)
    ys = torch.as_tensor(batch_seqs()[:BF16_BATCH].astype(np.int64), device=device)
    cases = {}
    for p in ("fp32", "bf16"):
        for label, name, static, _ in BF16_DECODES:
            cases[(label, p)] = functools.partial(build(name, precision=p, **static),
                                                  head.logA, head.logB, head.logPi, yd)
        cases[(f"recompute Bs={BF16_BATCH}", p)] = functools.partial(
            fused_decode_batch, head.logA, head.logB, head.logPi, ys, pointers="recompute",
            precision=p)
    for run in cases.values():
        run()
    return cases


def bf16_busy(hmm, y, device) -> None:
    """Each ``bf16_cases`` decode's device busy ms at both precisions
    (torch.profiler: three decodes a session, the sessions in turns fp32,
    bf16, bf16, fp32).  Run in a fresh process: a session records fewer of
    its kernels the more the process launched before it
    (``scripts/torch_profiler_records.py``), and after this script's
    earlier phases some recorded none."""
    cases = bf16_cases(tables(hmm, 128, device), y, device)
    order = ("fp32", "bf16", "bf16", "fp32")
    # a session may record only part of its decodes (PERF.md), which can only
    # lower a reading: the larger reading of each precision kept
    for label in dict.fromkeys(label for label, _ in cases):
        busy = {"fp32": [], "bf16": []}
        for p in order:
            run = cases[(label, p)]
            ms, launches, largest = device_profile(lambda: [run() for _ in range(3)], device)
            busy[p].append((ms / 3, launches / 3, largest))
        fp, bf = (max(busy[p]) for p in ("fp32", "bf16"))
        print(f"bf16 device busy, {label} decode: fp32 {fp[0]:.3f} ms ({fp[1]:.1f} launches), "
              f"bf16 {bf[0]:.3f} ms ({bf[1]:.1f} launches) a decode; sessions "
              f"{ {p: [(round(b[0], 3), b[1]) for b in busy[p]] for p in busy} }; largest bf16 "
              f"items (3 decodes) {bf[2]}", flush=True)


def kept_tables(head, yd, precision: str, device) -> tuple[int, int, int]:
    """A fresh flash N=SEGMENTS decoder at ``precision`` on the headline
    tables: (the bytes it keeps across calls and its first call's peak,
    both above what was allocated before it was built; a later call's peak
    above what was allocated before that call)."""
    from flash_viterbi_tpu_torch import build

    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    dec = build("flash", num_segments=SEGMENTS, precision=precision)
    args = (head.logA, head.logB, head.logPi, yd)
    dec(*args)
    torch.cuda.synchronize(device)
    kept = torch.cuda.memory_allocated(device) - before
    first = torch.cuda.max_memory_allocated(device) - before
    return kept, first, peak_run(dec, args, device)[2]


def bf16_phase(hmm, requests, oracles, device, witness) -> tuple[dict, list[dict[str, int]]]:
    """precision="bf16": the kernel checks (``bf16_kernel_checks``), then the
    four requests through ``decode(..., precision="bf16")`` for each of
    BF16_DECODES (fused, flash N=16 pointer, flash lean), each launching its
    kernels and no other, each path equal to the port's CPU bf16 decode
    (the witness) bit for bit and ``memory:`` the decoder's fp32 figure,
    the f64 score gap to the C oracle's exact path printed; ``auto`` in
    bf16 (it chooses fused) equal to fused's; ``decode_batch(..., "fused",
    precision="bf16")`` over BF16_BATCH sequences in both pointer modes,
    every row equal to its single bf16 fused decode on the card, the first
    four (the requests) the CPU's; then ``bf16_turns``.  Returns the kernel
    records and the decodes' launches."""
    from flash_viterbi_tpu_torch import build, decode, decode_batch
    from flash_viterbi_tpu_torch.algorithms.auto import choose
    from flash_viterbi_tpu_torch.oracle.validate import path_score_f64

    t0 = time.perf_counter()
    recs = bf16_kernel_checks(hmm, requests[0], device)
    spun = spin_up(device)
    K, T = hmm.K, len(requests[0])
    all_launches, paths = [], {}
    for label, name, static, needed in BF16_DECODES:
        results, launches = drive(
            f"bf16 {label}, {len(requests)} decodes", needed,
            lambda: [decode(hmm, y, name, precision="bf16", device=device, **static)
                     for y in requests])
        only(launches, needed)
        all_launches.append(launches)
        want_mem = build(name, **static).analytic_memory(K=K, T=T)
        for i, (y, r, oracle) in enumerate(zip(requests, results, oracles)):
            cpu_path, cpu_s = witness.get(f"bf16_{label}{i}")
            require(np.array_equal(r.path, cpu_path),
                    f"bf16 {label} request {i}: the card's path differs from the CPU decode")
            require(r.memory_bytes == want_mem, f"bf16 {label} request {i}: memory "
                    f"{r.memory_bytes} != {want_mem}")
            gap = (path_score_f64(hmm.A, hmm.B, hmm.Pi, y, oracle)
                   - path_score_f64(hmm.A, hmm.B, hmm.Pi, y, r.path))
            print(f"bf16 {label} request {i}: {r.time_s * 1e3:.3f} ms, equal to the CPU decode "
                  f"({cpu_s:.1f} s in the witness); {int((r.path != oracle).sum())} positions "
                  f"off the C oracle's exact path, f64 score gap {gap:.6g}", flush=True)
        paths[label] = np.stack([r.path for r in results])
    name, kw = choose(-(-K // 128) * 128, T, static={"precision": "bf16"})
    require(name == "fused", f"auto in bf16 chose {name} {kw} at the headline, not fused")
    needed = BF16_DECODES[0][3]
    results, launches = drive("bf16 auto, 4 decodes", needed, lambda: [
        decode(hmm, y, "auto", precision="bf16", device=device) for y in requests])
    only(launches, needed)
    all_launches.append(launches)
    require(np.array_equal(np.stack([r.path for r in results]), paths["fused"]),
            "bf16 auto: a path differs from fused's (and the CPU's)")
    print(f"bf16 auto: chose {name} {kw}; the four paths equal fused's bf16 paths, "
          f"{[round(r.time_s * 1e3, 3) for r in results]} ms", flush=True)
    lh = tables(hmm, 128, device)
    seqs = batch_seqs()[:BF16_BATCH]
    single = build("fused", precision="bf16")
    singles = np.stack([single(lh.logA, lh.logB, lh.logPi,
                               torch.as_tensor(q.astype(np.int64), device=device)).cpu().numpy()
                        for q in seqs])[:, :T]
    require(np.array_equal(singles[:len(requests)], paths["fused"]),
            "bf16 fused single decodes of the requests differ from decode()'s")
    log_tables = hmm.log(device=device)
    for pointers, needed in BF16_BATCH_NEEDS.items():
        r, launches = drive(f"bf16 batch Bs={BF16_BATCH} pointers={pointers}", needed,
                            lambda: decode_batch(log_tables, seqs, "fused", precision="bf16",
                                                 pointers=pointers, device=device))
        only(launches, needed)
        all_launches.append(launches)
        require(np.array_equal(r.path, singles),
                f"bf16 batch {pointers}: a row differs from its single bf16 decode")
        print(f"bf16 batch Bs={BF16_BATCH} pointers={pointers}: {r.time_s * 1e3:.3f} ms, rows "
              f"equal the single bf16 decodes (rows 0-3 the CPU's); {spun}", flush=True)
    bf16_turns(hmm, requests[0], device)
    print(f"bf16 phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return recs, all_launches


def fuzz_phase(device, witness) -> list[dict[str, int]]:
    """Phase 12c: the fixed fuzz draws of ``scripts/torch_fuzz_midscale.py``
    (FUZZ_MIDSCALE, FUZZ_SMALL, FUZZ_WIDE, the wide draws' C oracle made by
    the witness workers) and ``scripts/torch_fuzz_engines.py`` (the first
    FUZZ_ENGINES draws, their CPU decodes and oracles made by the witness
    workers) through the public decoders on the card; any mismatch fails.
    Each regime's draws run between a reset and a read of the launch
    counters: every kernel of its paths must launch, and the engine draws
    (no hand kernel) launch none.  Prints each draw's line, the coverage
    (scan plans, the bf16 tile copy's paths, the beam and fold clusters)
    and the phase's wall time.  Returns the launches."""
    from scripts import torch_fuzz_engines as fe
    from scripts import torch_fuzz_midscale as fm

    t0 = time.perf_counter()
    cov = fm.Coverage().install()
    launches = []
    try:
        for regime, seeds in (("midscale", FUZZ_MIDSCALE), ("small", FUZZ_SMALL),
                              ("wide", FUZZ_WIDE)):
            needs = FUZZ_NEEDS
            if regime == "small" or any(seed % 4 == 0 for seed in seeds):
                needs += FUZZ_BEAM_NEEDS
            if regime != "small" and any(seed % 2 == 0 for seed in seeds):
                needs += FUZZ_BF16_NEEDS

            def run(regime=regime, seeds=seeds):
                for i, seed in enumerate(seeds):
                    t1 = time.perf_counter()
                    oracle = (None if regime != "wide"
                              else lambda i=i: witness.get(f"fuzz_wide{i}")[0])
                    d = fm.one_round(seed, regime, device, oracle)
                    print(f"fuzz {regime}: {fm.draw_line(d, cov.take(), time.perf_counter() - t1)}",
                          flush=True)
                    require(not d.failures, f"fuzz {regime} seed={seed}: {d.failures}")

            launches.append(drive(f"fuzz {regime}, {len(seeds)} draws", needs, run)[1])

        def engines():
            for i, p in enumerate(fe.draws(FUZZ_ENGINES, fe.DEFAULT[1])):
                t1 = time.perf_counter()
                r = fe.one_round(p, device, witness.record(f"fuzz_engines{i}"))
                print(f"fuzz engines: {fe.draw_line(p, r, time.perf_counter() - t1)}", flush=True)
                require(not r["failures"], f"fuzz engines {fe.ctx(p)}: {r['failures']}")

        eng = drive(f"fuzz engines, {FUZZ_ENGINES} draws", (), engines)[1]
        only(eng, ())
        launches.append(eng)
    finally:
        cov.uninstall()
    print(cov.summary(), flush=True)
    print(f"fuzz phase: {len(FUZZ_MIDSCALE)} midscale, {len(FUZZ_SMALL)} small, "
          f"{len(FUZZ_WIDE)} wide and {FUZZ_ENGINES} engine draws, 0 mismatches, "
          f"{time.perf_counter() - t0:.1f} s (the sharded draws ran in phase 10's worlds)",
          flush=True)
    return launches


def trace_phase() -> dict[str, int]:
    """``device_trace`` around one fused decode (its warmup and timed call)
    of the headline's request 0, in a fresh process on the card
    (``trace_main``: this script with ``--trace``), last in the script: host
    timings after a torch.profiler session run slower, and a session in
    this process after the earlier phases has recorded only some of the
    decode's kernels, or none.  The Chrome trace must be written and hold
    each launch of the decode's two hand kernels; the process's
    ``bf16_busy`` lines are printed.  Returns the launches."""
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace", out],
                              capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
        print(proc.stdout, end="", flush=True)
        require(proc.returncode == 0, f"device_trace: the process exited with "
                f"{proc.returncode}: {proc.stderr[-4000:]}")
        with open(os.path.join(out, "trace.json")) as f:
            rec = json.load(f)
    launches, kernels = rec["launches"], rec["kernels"]
    count = {name: sum(n for k, n in kernels.items() if pattern in k)
             for name, pattern in TRACE_KERNELS.items()}
    require(rec["bytes"] > 0 and all(count[n] == launches[n] for n in TRACE_KERNELS),
            f"device_trace: {rec['bytes']} bytes; hand kernel events {count} against "
            f"launches {nonzero(launches)}; kernel events {kernels}")
    print(f"device_trace of one fused decode (warmup and timed call, a fresh process, "
          f"{time.perf_counter() - t0:.1f} s): {rec['bytes']} bytes, {rec['events']} events, "
          f"{sum(kernels.values())} kernels ({count}), {rec['busy_ms']:.3f} ms of kernel time",
          flush=True)
    return launches


def trace_main(outdir: str) -> None:
    """The ``--trace`` process of ``trace_phase``: load the built kernels,
    run one fused decode of the headline's request 0 under ``device_trace``
    between a reset and a read of the launch counters, and write the
    launches and the trace's kernel events by name to ``outdir``; then
    ``bf16_busy`` (phase 12b's device busy readings)."""
    from flash_viterbi_tpu_torch import decode
    from flash_viterbi_tpu_torch.runtime import build
    from flash_viterbi_tpu_torch.utils.profiling import device_trace

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build.kernels()
    hmm, requests = headline()
    with tempfile.TemporaryDirectory() as log_dir:
        def run():
            with device_trace(log_dir):
                decode(hmm, requests[0], "fused", device=device)

        _, launches = drive("device_trace", TRACE_KERNELS, run)
        trace = os.path.join(log_dir, "trace.json")
        size = os.path.getsize(trace) if os.path.exists(trace) else 0
        with open(trace) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name: dict[str, int] = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
    with open(os.path.join(outdir, "trace.json"), "w") as f:
        json.dump({"launches": launches, "bytes": size, "events": len(events),
                   "kernels": by_name, "busy_ms": sum(e.get("dur", 0) for e in kernels) / 1e3},
                  f)
    bf16_busy(hmm, requests[0], device)


def headline() -> tuple:
    """(HMM, the four requests: the seed-1 sequence and
    ``observations(T, M, seed=s)`` for s in EXTRA_SEEDS)."""
    from flash_viterbi_tpu_torch.models.generate import make_sparse_hmm, observations

    hmm, y1 = make_sparse_hmm(**HEADLINE)
    return hmm, [y1] + [observations(HEADLINE["T"], HEADLINE["M"], seed=s)
                        for s in EXTRA_SEEDS]


def rank_main(init_method: str, rank: str, world: str, outdir: str) -> None:
    """One rank of a multi-rank phase, started by ``run_ranks`` with the job
    in ``FVT_SMOKE_JOB``: join the gloo world, upload this rank's column
    shard of the tables to ``cuda:0``, decode (after a warmup if the job
    asks), and write the paths, the decode's CUDA-event time and the
    launches of the timed decode into ``outdir``."""
    from flash_viterbi_tpu_torch.ops import cuda as k
    from flash_viterbi_tpu_torch.parallel import multihost
    from flash_viterbi_tpu_torch.parallel.sharded import flash_decode_sharded, make_mesh

    job = json.loads(os.environ["FVT_SMOKE_JOB"])
    rank = int(rank)
    torch.set_num_threads(1)  # the ranks share the host's cores
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    multihost.initialize(init_method, int(world), rank, backend="gloo")
    mesh = make_mesh(*job["mesh"])
    if job["problem"] == "headline":
        hmm, requests = headline()
        lh = hmm.log(device="cpu").padded(128)
        logA, logB, logPi = (t.numpy() for t in (lh.logA, lh.logB, lh.logPi))
        ys = np.stack(requests)
    else:
        logA, logB, logPi, ys = (np.load(os.path.join(job["problem"], f"{n}.npy"), mmap_mode="r")
                                 for n in ("logA", "logB", "logPi", "ys"))
    Kd = logA.shape[0] // mesh.shape["state"]
    lo = mesh.coords[2] * Kd

    def upload(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    logA_l, logB_l, logPi_d = upload(logA[:, lo:lo + Kd]), upload(logB[lo:lo + Kd]), upload(logPi)
    ys = np.asarray(ys)

    def run():
        return flash_decode_sharded(mesh, logA_l, logB_l, logPi_d, ys,
                                    num_segments=job["segments"],
                                    microbatch=job["microbatch"])

    if job["warmup"]:
        run()
    k.reset_launches()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    paths = run()
    end.record()
    end.synchronize()
    np.save(os.path.join(outdir, f"rank{rank}.npy"), paths.cpu().numpy())
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "coords": mesh.coords, "ms": start.elapsed_time(end),
                   "launches": nonzero(k.launch_counts()),
                   "shard_bytes": logA_l.numel() * logA_l.element_size()}, f)
    if job.get("fuzz"):
        from scripts.torch_fuzz_sharded import rank_draws

        rank_draws(job["fuzz"], rank, device, outdir)
    multihost.shutdown()
    with open(os.path.join(outdir, f"ok_{rank}"), "w") as f:
        f.write("ok")


def main() -> None:
    t_start = time.perf_counter()
    device = device_phase()
    build_phase()
    witness = Witness()
    try:
        phases(device, witness, t_start)
    finally:
        witness.stop()


def phases(device, witness: Witness, t_start: float) -> None:
    """Phases 3 to 13 and the closing lines, the CPU decodes of phases 4,
    8c and 12 read from ``witness``."""
    from flash_viterbi_tpu_torch.oracle import native

    hmm, requests = headline()
    y1 = requests[0]
    recs = kernel_phase(hmm, y1, device)
    t0 = time.perf_counter()
    probe_recs = probe_check_phase(device)
    print(f"probe kernels against their plain versions: {time.perf_counter() - t0:.1f} s",
          flush=True)
    probe_launches = probe_phase(device, probe_recs, recs)
    gbps = hbm_read_gbps(device)
    scan_floor_phase(hmm, device, recs, gbps)
    Kp, steps = tables(hmm, 128, "cpu").Kp, HEADLINE["T"] - 1
    floor_ms = steps * Kp * Kp * 4 / (gbps * 1e9) * 1e3
    print(f"HBM read {gbps:.1f} GB/s measured; the one-step design's streaming "
          f"floor at K={Kp}: {steps} steps x {Kp * Kp * 4 / 2**20:.0f} MiB = "
          f"{floor_ms:.3f} ms at the measured rate, "
          f"{steps * Kp * Kp * 4 / card().bytes_per_s * 1e3:.3f} ms at the published "
          f"3.35 TB/s", flush=True)
    t0 = time.perf_counter()
    oracles = [native.vanilla(hmm.A, hmm.B, hmm.Pi, y) for y in requests]
    print(f"C oracle: {len(requests)} decodes in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cpu = torch.device("cpu")
    beam_paths = {}
    launches = ([slice_phase(hmm, requests, oracles, device, witness)]
                + checkpoint_phase(hmm, requests, oracles, device)
                + beam_phase(hmm, requests, oracles, device, cpu, witness, beam_paths)
                + [beam_large_phase(device, cpu), long_t_phase(hmm, device)]
                + batch_phase(hmm, device))
    launches += lean_auto_harness_phase(hmm, requests, oracles, device, cpu)
    launches += sieve_phase(hmm, requests, oracles, device, cpu, witness)
    launches += sieve_dyn_phase(hmm, requests, device, witness)
    print(f"CPU witness: the phases waited {witness.waited:.1f} s for it in all", flush=True)
    launches += flash_long_phase(hmm, requests, oracles, device)
    launches += routes_phase(device)
    launches.append(tools_phase(hmm, requests, oracles, device, witness, beam_paths))
    sharded_paths, sharded_launches = sharded_phase(hmm, requests, oracles, device, cpu)
    multi_rank_phase(sharded_paths)
    launches += [sharded_launches, *config5_phase(device), probe_launches]
    bf16_recs, bf16_launches = bf16_phase(hmm, requests, oracles, device, witness)
    launches += bf16_launches
    launches += fuzz_phase(device, witness)
    launches.append(sieve_bs_paper_phase(hmm, y1, device))  # after every profiler session
    launches.append(trace_phase())  # last: a profiler session slows the host
    recs.update(probe_recs)
    recs.update(bf16_recs)
    table = {**KERNELS, **PROBE_KERNELS}
    total = {name: sum(run[name] for run in launches) for name in table}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": table[name][0],
         "replaces": table[name][1], "launches": total[name],
         **{key: recs[name][key] for key in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")},
         "latency_floor_ms": recs[name].get("latency_floor_ms")}
        for name in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 5:  # one rank of a multi-rank phase (run_ranks)
        rank_main(*sys.argv[1:])
    elif sys.argv[1:2] == ["--cpu-witness"]:  # a Witness worker
        witness_main(*sys.argv[2:])
    elif sys.argv[1:2] == ["--trace"]:  # the process of trace_phase
        trace_main(*sys.argv[2:])
    else:
        main()
