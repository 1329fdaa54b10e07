"""The data-parallel GAN and encoder steps of tests/test_torch_parallel.py in
float64: world 2 against world 1 on gloo CPU ranks.

In fp32 the two worlds' steps differ by the rounding of another reduction
order (the ranks' batch of 2 against one process's 4, and the flat gradient
all-reduce): up to 3.6e-4 of a tensor's max in the encoder's Adam moments.
Here the port's fp32 compute is made float64 (tests/torch_parallel_ranks.py,
`compute_dtype`), and every parameter, Adam moment, G_ema and pl_mean must
agree within 1e-10 x max|ref|: the readings are 4.1e-13 at most (the
encoder's parameters; 1.2e-14 its moments, below 7e-14 the GAN step's). A
fault across ranks (a missed average, a draw or a pose swap off by one rank)
would show at the size of a gradient, not of float64 rounding."""

import numpy as np

from test_torch_parallel import (  # noqa: F401 (pools: a module-scoped fixture)
    _same_trees, encoder_step_runs, gan_step_check, pools)
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

F64_TOL = 1e-10  # x max|ref|


def test_gan_step_world_2_matches_world_1_in_float64(pools):
    ref, got = gan_step_check(pools, "float64", F64_TOL)
    assert got[0]["ada_p"] == got[1]["ada_p"] == ref["ada_p"] != 0.3


def test_encoder_step_world_2_matches_world_1_in_float64(pools):
    ref, got = encoder_step_runs(pools, "float64")
    assert np.isfinite(got[0]["loss_total"]) and got[0]["loss_total"] > 0
    _same_trees(got[0]["E"], ref["E"], "E", F64_TOL)
    _same_trees(got[0]["opt_e"], ref["opt_e"], "opt_e", F64_TOL)
