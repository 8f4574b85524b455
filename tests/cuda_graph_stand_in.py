"""A CPU stand-in for ``utils/cuda_graphs.GraphPool``, shared by the tests
of the guided denoiser's graphs and of the training step's.

``install(monkeypatch)`` allows capture on the CPU and replaces the pool's
``run`` and ``capture``: ``run`` calls the function; ``capture`` runs the
body once, which stands for the capture and its first replay, and each
later replay reruns it and writes its results into the first run's
outputs, as a graph's replay rewrites its own tensors.
"""
import types

from convofusion_tpu_torch.utils import cuda_graphs


def copy_out(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            copy_out(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            copy_out(d, s)
    elif dst is not None:
        dst.copy_(src)


def install(monkeypatch):
    """The stand-in in place until ``monkeypatch`` undoes it; returns the
    list that gets each capture's generators."""
    captures = []

    def run(self, fn, device):
        return fn()

    def capture(self, fn, device, warmup=True, generators=()):
        captures.append(tuple(generators))
        out = fn()
        ran = {"first": True}

        def replay():
            if not ran.pop("first", False):
                copy_out(out, fn())

        return types.SimpleNamespace(replay=replay), out

    monkeypatch.setattr(cuda_graphs, "CAPTURE_DEVICES", ("cpu", "cuda"))
    monkeypatch.setattr(cuda_graphs.GraphPool, "run", run)
    monkeypatch.setattr(cuda_graphs.GraphPool, "capture", capture)
    return captures
