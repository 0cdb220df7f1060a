"""Port parity: the partitioned route's balancing and imported modes
against the JAX package's, on the CPU, on 8 shards: the checks of
tests/test_torch_partitioned.py `check_step` (outputs, the flush, the
telemetry block, every shard's state, the digests against both the JAX
package and the oracle), in a file of their own because each of these
JAX steps takes ~35 s to compile.
"""

import pytest
import torch

from tests.test_torch_partitioned import check_step, pre_states

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pre():
    return pre_states((8,))


@pytest.mark.parametrize("mode", ["balancing", "imported"])
def test_step_equals_the_jax_packages(pre, mode):
    check_step(pre, 8, mode)
