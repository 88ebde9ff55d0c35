"""Small overrides of the cells' traffic files, so that a whole run, the
check with it, fits a CPU test."""

TINY = {"lanes": [2, 6], "iterations": 2,
        "train_app": {"seed": 1, "n_phases": 1},
        "eval_app": {"seed": 2, "n_phases": 1, "case_study": [],
                     "tile_seed": 4}}
CELLS = {
    "table4-qtable-train": {**TINY, "weights": [[0.675, 0.075, 0.25],
                                                [0.2, 0.2, 0.6]],
                            "seeds_per_weighting": 1},
}


def run_cell(cell: str, seed: int, fault: str | None = None,
             trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU (the harness's look for a card
    skipped), optionally with the timed path broken by ``fault``."""
    import torch
    from perfbench import faults, harness
    threads = torch.get_num_threads()
    torch.set_num_threads(1)             # tiny tensors: no thread pool
    try:
        run = harness.Run(harness.load_benchmark(), cell, seed, 0.0, trace,
                          device="cpu", overrides=CELLS[cell])
        if fault is not None:
            run.warm = False             # as perfbench/faults.py runs them
            faults.install(run, fault)
        return harness.execute(run)
    finally:
        torch.set_num_threads(threads)
