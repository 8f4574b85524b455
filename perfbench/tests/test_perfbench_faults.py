"""A run with the timed path broken underneath reads ``correct`` false:
every fault a cell can have, planted in the program, on the CPU at a tiny
size (fp32), judged by the cell's own limits.  The sound run beside them
reads true."""
import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

SAMPLE = "cf_sample_b32"
TRAIN = ["vae_train_s1", "cf_train_s2"]


def run(cell, tmp_path):
    return harness.run(tiny.context(cell, tmp_path))


@pytest.mark.parametrize("cell", [SAMPLE] + TRAIN)
def test_sound_run_is_correct(cell, tmp_path):
    assert run(cell, tmp_path)["correct"]


def _wrap_sampler(monkeypatch, change):
    from convofusion_tpu_torch.models import convofusion

    call = convofusion.CachedSampler.__call__

    def broken(self, *args, **kwargs):
        motion, latents = call(self, *args, **kwargs)
        return change(motion, latents)

    monkeypatch.setattr(convofusion.CachedSampler, "__call__", broken)


def test_sample_answer_altered(monkeypatch, tmp_path):
    def change(motion, latents):
        motion = motion.clone()
        motion[0] = -motion[0]
        return motion, latents
    _wrap_sampler(monkeypatch, change)
    assert not run(SAMPLE, tmp_path)["correct"]


def test_sample_half_batch_left_out(monkeypatch, tmp_path):
    def change(motion, latents):
        h = motion.shape[0] // 2
        return (torch.cat([motion[:h], motion[:motion.shape[0] - h]]),
                torch.cat([latents[:h], latents[:latents.shape[0] - h]]))
    _wrap_sampler(monkeypatch, change)
    assert not run(SAMPLE, tmp_path)["correct"]


def test_sample_step_returns_its_state(monkeypatch, tmp_path):
    from convofusion_tpu_torch.models import convofusion

    monkeypatch.setattr(convofusion, "guided_step",
                        lambda np7, latents, *a: latents.clone())
    assert not run(SAMPLE, tmp_path)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_step_returns_its_state(cell, monkeypatch, tmp_path):
    from convofusion_tpu_torch.train.trainer import Trainer

    def unchanged(self):
        for p in self.params:
            p.grad = None
    monkeypatch.setattr(Trainer, "apply_grads", unchanged)
    assert not run(cell, tmp_path)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_half_batch_left_out(cell, monkeypatch, tmp_path):
    from convofusion_tpu_torch.train.trainer import Trainer

    compute = Trainer.compute_grads

    def half(self, batch, generator=None, draws=None):
        b = next(iter(batch.values())).shape[0]
        batch = {k: v[:b // 2] for k, v in batch.items()}
        draws = {k: (v[:, :b // 2] if k == "eps" else v[:b // 2])
                 for k, v in draws.items()}
        return compute(self, batch, generator, draws)
    monkeypatch.setattr(Trainer, "compute_grads", half)
    assert not run(cell, tmp_path)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_loss_altered(cell, monkeypatch, tmp_path):
    """The loss 5% off where the model computes it, before the backward."""
    from convofusion_tpu_torch.models.convofusion import Convofusion

    for name in ("train_vae_loss", "train_diffusion_loss"):
        loss_fn = getattr(Convofusion, name)

        def altered(self, *args, _fn=loss_fn, **kwargs):
            total, terms = _fn(self, *args, **kwargs)
            return total * 1.05, terms
        monkeypatch.setattr(Convofusion, name, altered)
    assert not run(cell, tmp_path)["correct"]
