"""One sharded train step of the reduced zamba2-2.7b (Mamba2's chunked
SSD form on DTensors, the shared attention block) and rwkv6-1.6b (the
WKV6 recurrence per rank) on 8 gloo ranks, a 4 x 2 mesh, against the
port's single-device step, with the tolerances of
``test_torch_distributed.py`` (the helpers are in ``_torch_dist.py``).
"""
import pytest

from _torch_dist import check_train, sharded_train

ARCHS = ("zamba2-2.7b", "rwkv6-1.6b")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return sharded_train(ARCHS, tmp_path_factory.mktemp("train"))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_single_device(arch, trained):
    check_train(trained[arch])
