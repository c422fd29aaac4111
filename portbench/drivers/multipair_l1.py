"""The driver of a configuration file without a "driver" key: the multi-pair
trainer of the `parallel` recipe in its L1 phase (`MultipairTrainer.step`,
`early` never set), on a cube mesh at order 1 or 2.  It re-exports the
harness' own modules; the contract is in harness/main.py."""

from harness import check, faults, inputs, program

TRAFFIC_KEYS = inputs.TRAFFIC_KEYS
make_inputs = inputs.make
Program = program.Program
NAMES = check.NAMES
numbers = check.numbers
FAULTS = faults.FAULTS
plant = faults.plant
heal = faults.heal


def dims(cfg: dict, inp: dict) -> dict:
    return {"B": inp["targets"].shape[0], "M": cfg["mode_num"],
            "k": cfg["mode_num"] + cfg["extra_modes"], "T": cfg["frame_num"],
            "F": cfg["force_frame_num"], "n_ffts": list(cfg["n_ffts"]),
            "E": inp["tets"].shape[0], "nodes": inp["tets"].shape[1], "V": inp["verts"].shape[0]}


def program_tracing():
    """diffsound_torch's own spans and counters; None where this build of
    the program has no `tracing()`."""
    try:
        from diffsound_torch.utils.profiler import counters, tracing
    except ImportError:
        return None
    return {"tracing": tracing, "counters": counters, "prefix": "diffsound."}
