"""Mid-scale fuzz of the PyTorch port's ``sieve_bs`` against the JAX package.

Samples ``scripts/fuzz_engines.py``'s regime (K 96-512, T 48-256, near-tie
edge densities, DAG inputs, tiny beams that reach the sentinel and beam
fallout) and adds a non-uniform Pi to a third of the draws.  A dense DAG
drives the forward beam up to the last states, which cannot last the
remaining steps, so under a beam narrower than about T the root prunes
every median candidate and the decode is one ``(-1, -1)`` pair: DAG draws
take T 48 or 64 and a beam of 2T, so that their trees recurse.  A draw
whose first sequence decodes to that one sentinel pair is counted as
degenerate, apart from the others.  Per fixture:

* the port's pair list (``flash_viterbi_tpu_torch.algorithms.sieve_bs`` on
  the CPU) equals JAX's ``sieve_bs_decode_many`` with ``engine="device"``
  and with ``engine="host"``;
* every fifth: a batch of three sequences equals the per-sequence decodes.

Any exception counts as a failure of that draw (not only an assertion),
and the run goes on.  Runs on the CPU:

    python scripts/torch_fuzz_sieve_bs.py [n_rounds] [seed0]
"""

import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import flash_viterbi_tpu as jfv  # noqa: E402
import flash_viterbi_tpu_torch as tfv  # noqa: E402
from flash_viterbi_tpu.algorithms.sieve_bs import sieve_bs_decode_many as jax_many  # noqa: E402
from flash_viterbi_tpu_torch.algorithms.sieve_bs import sieve_bs_decode_many  # noqa: E402
from flash_viterbi_tpu_torch.models.generate import make_dag_hmm  # noqa: E402


def pairs(many):
    return [[tuple(int(v) for v in p) for p in one] for one in many]


def main() -> int:
    n_rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 25
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 50_000
    torch.set_num_threads(2)
    failures, degenerates = [], []
    rng = np.random.default_rng(seed0)
    t_start = time.perf_counter()
    for i in range(n_rounds):
        K = int(rng.choice([96, 128, 160, 256, 384, 512]))
        T = int(rng.choice([48, 64, 96, 128, 192, 256]))
        M = int(rng.integers(4, 40))
        prob = float(rng.choice([0.02, 0.05, 0.1, 0.2]))
        seed = int(rng.integers(0, 10_000))
        dag = bool(rng.integers(0, 3) == 0)
        nonuniform = bool(rng.integers(0, 3) == 0)
        bw = int(rng.choice([2, 4, 8, 16, 32]))
        if dag:  # sizes whose trees recurse (no extra draw: the others stay as they were)
            T = 48 if T <= 96 else 64
            bw = 2 * T
        what = (f"K={K} T={T} M={M} prob={prob} seed={seed} dag={dag} "
                f"nonuniform_pi={nonuniform} bw={bw}")
        try:
            t0 = time.perf_counter()
            if dag:
                hmm, y = make_dag_hmm(K=K, M=M, T=T, seed=seed, sanitize=True)
            else:
                hmm, y = tfv.make_sparse_hmm(K=K, M=M, T=T, prob=prob, seed=seed)
            if nonuniform:
                pi = np.random.default_rng(seed + 2).uniform(0.05, 1.0, K)
                hmm = tfv.HMM(hmm.A, hmm.B, pi / pi.sum())
            ys = np.asarray(y)[None]
            if i % 5 == 0:
                more = np.random.default_rng(seed + 1).integers(0, M, size=(2, T))
                ys = np.concatenate([ys, more.astype(ys.dtype)])
            lh = hmm.log(device="cpu")
            port = sieve_bs_decode_many(lh.logA, lh.logB, lh.logPi, ys, bw)
            jl = jfv.HMM(hmm.A, hmm.B, hmm.Pi).log()
            tbl = (jnp.asarray(jl.logA), jnp.asarray(jl.logB), jnp.asarray(jl.logPi))
            for engine in ("device", "host"):
                want = pairs(jax_many(*tbl, ys[:1], bw, engine=engine))
                assert port[:1] == want, f"port != JAX engine={engine}"
            for s in range(1, len(ys)):
                one = sieve_bs_decode_many(lh.logA, lh.logB, lh.logPi, ys[s:s + 1], bw)[0]
                assert port[s] == one, f"batched != single at sequence {s}"
            sentinels = sum(p == (-1, -1) for p in port[0])
            degenerate = port[0] == [(-1, -1)]
            if degenerate:
                degenerates.append(i)
            print(f"[{i}] ok {what} pairs={len(port[0])} sentinels={sentinels} "
                  f"{'DEGENERATE ' if degenerate else ''}sequences={len(ys)} "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        except Exception as e:  # any exception fails the draw, not only an assertion
            failures.append((i, what, f"{type(e).__name__}: {e}"))
            print(f"[{i}] FAIL {what}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
        if i % 8 == 7:
            jax.clear_caches()  # each shape compiles new programs; the cache grows
    print(f"done: {n_rounds - len(failures)}/{n_rounds} ok in "
          f"{time.perf_counter() - t_start:.1f} s; degenerate draws (one sentinel pair): "
          f"{len(degenerates)} {degenerates}; failures: {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
