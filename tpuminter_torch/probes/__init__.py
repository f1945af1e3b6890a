"""The TPU rounds' layout probes on the card: one module per script of
``scripts/`` that holds a ``pallas_call`` not on the miner's path.

Each is named after its script and runs as ``python -m
tpuminter_torch.probes.<name> [--device cpu] [--b B] [--n N]``: on the
card (the default) through the kernels P1-P3 of ``kernels.probes``, on
the CPU through their plain versions. Each has ``run(device, ...) ->
dict``, which ``chip_smoke.py`` calls, and ``main(argv)``, which prints
what its script printed. Each keeps its script's stages: a 4-step
data-dependent chain checked against the fused walk (19,
``kernels.scrypt.romix_walk``) where the design computes scrypt's walk,
then a 1024-step walk or repeated calls, timed beside 19's µs a step.
"""

#: the probe modules, in the order of their sites in PERF.md's table
PROBES = (
    "kernel_body_probe", "pallas_launch_overhead_probe", "transpose_micro_probe",
    "walk_isolate_probe", "walk_native_tile_probe", "walk_pallas_probe", "walk_variants_probe",
    "walk_wm2_probe", "walk_wm_probe", "hlo_layout_check",
)

__all__ = ["PROBES"]
