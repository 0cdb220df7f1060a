"""Port parity: live resharding's controller end to end on a mesh of 8.

The JAX package's testing/reshard_smoke._mesh_run on both packages at 8
shards (the port's logical shards of the CPU, the JAX package's 8 host
devices): a split, a migrate and a merge_back under live traffic, every
window's results, each stage's records and each digest equal, the port's
storage unmoved (tests/test_torch_resharding.py's `mesh_run`, the port's
testing/reshard_smoke.py with the JAX controller in lockstep, which runs
the mesh of 2). A file of its own: the JAX package compiles a chain step
an overlay at 8 devices, ~130 s.
"""

import torch

from tests.test_torch_resharding import mesh_run

torch.set_num_threads(1)


def test_controller_mesh_run_on_8_shards_equals_the_jax_packages(tmp_path):
    tw = mesh_run(8, tmp_path)
    assert tw.ctl.migrations[1]["dst"] == 7
