"""Hopper counterparts of the JAX package's measurement probes (``scripts/``).

    python -m flash_viterbi_tpu_torch.probes [alu] [scan] [beam_profile] [beam_profile2] [copy]

==================  =======================================  ========================
probe               TPU probe                                kernel
==================  =======================================  ========================
``alu``             ``vpu_probe.py:vpu_peak``                ``csrc/probe_alu.cu``
``scan``            ``vpu_probe.py:ablation``                ``csrc/maxplus_scan.cu``
``beam_profile``    ``beam_profile.py:run_variant``          ``csrc/probe_beam.cu``
``beam_profile2``   ``beam_profile2.py:run_variant``         ``csrc/probe_beam.cu``
``copy``            ``beam_dma_probe.py:p1, p3, p4, p5``     ``csrc/probe_copy.cu``
                    (p4, p5 also as clusters)
==================  =======================================  ========================

Each probe runs on the card unless asked for the CPU, where the kernels'
plain versions run (slowly at these shapes) and the variants that have no
plain version are skipped.  Each returns one record a variant, named as
the JAX script names it where it has a counterpart, with its time per call
(``bench.harness.marginal_time``; the scan ablation's and ``probe_alu``'s
device time back to back, ``bench.harness.queued_ms``) and the bytes and
operations a call must move and do, from which ``bench/bounds.py`` makes a
bound.  No probe writes a file.
"""

from . import alu, beam, copy, scan

WRAPPERS = (alu.probe_alu, scan.probe_scan_ablation, beam.probe_beam_parts,
            beam.probe_beam_select, copy.probe_copy_p1, copy.probe_copy_p3,
            copy.probe_copy_p4, copy.probe_copy_p5, copy.probe_copy_p4_cluster,
            copy.probe_copy_p5_cluster)

PROBES = {"alu": alu.run, "scan": scan.run, "beam_profile": beam.run_parts,
          "beam_profile2": beam.run_select, "copy": copy.run}


def launch_counts() -> dict[str, int]:
    """Kernel launches made by each probe wrapper since the last reset."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def run(names=None, device="cuda") -> list[dict]:
    """Run the probes ``names`` (all by default, in :data:`PROBES` order)
    on ``device``; returns their records."""
    unknown = sorted(set(names or ()) - set(PROBES))
    if unknown:
        raise ValueError(f"unknown probes {unknown}; choose from {list(PROBES)}")
    return [rec for name in (names or PROBES) for rec in PROBES[name](device=device)]
