"""A dropped model's weights go with its last reference, without the
garbage collector.

The model keeps its cached samplers (``Convofusion.cached_sampler``); a
sampler holding the model back made a reference cycle that kept a dropped
model's weights (on the card) until the garbage collector ran.  Now
``del model`` frees the weights at once, and a sampler whose model is gone
raises a clear error.  The HTTP front end and the 'random' focus words made
two more such cycles (a handler class closing over the service; nltk's
first import holding its callers' frames), closed the same way.
"""
import gc
import random
import threading
import weakref

import pytest
import torch

from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.cli import focus
from convofusion_tpu_torch.models.convofusion import Convofusion
from convofusion_tpu_torch.serving import GestureService, serve_http


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tiny shapes on one intra-op thread: beside the other
    test workers, OpenMP teams as wide as the machine wait on each other,
    and these steps took ~50x longer than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_gc():
    """The garbage collector off: only reference counts free memory."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def test_del_model_frees_its_weights_without_gc(no_gc):
    model = Convofusion(TINY, device="cpu", seed=0)
    batch, _, _ = prepare_arrays(model, synthetic_raw_batch(0, 2))
    sampler = model.cached_sampler(num_inference_steps=2)
    motion, _ = sampler(batch, torch.Generator().manual_seed(0))
    assert motion.shape == (2, 128, 189)
    weight = weakref.ref(model.denoiser.latent_embd.weight)
    del model
    assert weight() is None
    with pytest.raises(RuntimeError, match="model was deleted"):
        sampler(batch, torch.Generator().manual_seed(0))


def test_samplers_are_still_shared_and_cached():
    model = Convofusion(TINY, device="cpu", seed=0)
    batch, _, _ = prepare_arrays(model, synthetic_raw_batch(0, 2))
    sampler = model.cached_sampler(num_inference_steps=2)
    assert model.cached_sampler(num_inference_steps=2) is sampler
    assert sampler.model is model
    first = sampler.uncond_for(batch)
    assert sampler.uncond_for(batch) is first
    model.load_state_dict(model.state_dict())      # new weights version
    assert sampler.uncond_for(batch) is not first


def test_closed_http_service_frees_its_model_without_gc(no_gc):
    svc = GestureService(Convofusion(TINY, device="cpu", seed=0),
                         batch_size=2, num_inference_steps=2)
    server = serve_http(svc, port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    server.shutdown()
    server.server_close()
    th.join(timeout=60)
    svc.close()
    weight = weakref.ref(svc.model.denoiser.latent_embd.weight)
    del svc, server
    assert weight() is None


def test_random_focus_words_keep_no_caller_frames(no_gc):
    class Held:
        pass

    def caller():
        held = Held()
        words = focus.select_focus_words(
            "random", ["the quick brown fox jumps"], rng=random.Random(0))
        assert words and words[0]
        return weakref.ref(held)

    focus._nltk_tagger.cache_clear()
    assert caller()() is None
