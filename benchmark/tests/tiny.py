"""Sizes at which the tests run each cell on the CPU, through the plain
versions of the program's kernels: every width as configured where the
CPU can hold it, with fewer points, a shallower tree and fewer images."""

LINREG = {
    "config": {"n_data": 4000, "temper": 0.025,
               "sampler": {"N": 1, "depth": 4, "step_size": 0.02,
                           "trans_sigma": 1.0, "selection": "all_first"}},
    "traffic": {"chunk": 200, "burn_in_launches": 2, "chains": 4, "thin": 2,
                "steps_per_launch": 16, "check_states": 32,
                "control": {"chains": 256, "steps": 600}},
}
LSTM = {
    "config": {"n_train": 64},
    "traffic": {"steps_per_launch": 2, "check_states": 4},
}


def overrides(cell_name: str) -> dict:
    return LSTM if "lstm" in cell_name else LINREG
