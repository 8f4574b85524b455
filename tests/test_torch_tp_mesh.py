"""Tensor parallelism on four gloo ranks (``parallel/tp.py``): a (2, 2)
dp x tp mesh in stage 2, and a (1, 4) mesh in stage 1, where the VAE's two
attention heads do not divide by the four model ranks and its attentions
run on the all-gathered q/k/v.  Each against one process on the global
batch with the global draws, at ``test_torch_tp.py``'s tolerances: the
gradient mean over the 'data' axis alone, and the clip's global norm over
split and replicated tensors, give one process's step."""
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_tp import check_tp_run  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_data,stage", [(2, "diffusion"), (1, "vae")])
def test_four_ranks_equal_one_process(tmp_path, n_data, stage):
    check_tp_run(tmp_path, 4, n_data, stage)
