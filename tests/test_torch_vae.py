"""VAE decode of the PyTorch port against JAX ``vae_decode`` at the tiny
geometry, fp32, on JAX ``init_params`` weights."""
import jax
import numpy as np
import torch

from convofusion_tpu.config.testing import tiny_config
from convofusion_tpu.models.convofusion import Convofusion as JaxConvofusion
from convofusion_tpu_torch.compat.from_jax import state_dict_from_jax
from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.models.convofusion import Convofusion

# fp32: two 3-layer skip decoders over 128 queries, outputs of O(1)
ATOL = 2e-5


def test_decode_matches_jax():
    jm = JaxConvofusion(tiny_config("diffusion"))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tm = Convofusion(TINY, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(params))

    z = np.random.default_rng(0).standard_normal((2, 3, 8, 32)).astype(
        np.float32)
    want = jm.vae_decode(params, z)
    with torch.no_grad():
        got = tm.vae.decode(torch.from_numpy(z), 128)
    assert got.shape == (3, 128, 189)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
