"""The port's serving path (convofusion_tpu_torch/serving.py) on the CPU at
the tiny geometry: micro-batching and occupancy, validation, backpressure
(503 through HTTP), WEG focus routing, weight swaps invalidating the uncond
cache, the HTTP endpoint and the CLI, draining on close, and a service batch
equal to a direct cached-sampler call.  Mirrors tests/test_serving.py.
Every blocking wait has a timeout."""
import copy
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from convofusion_tpu_torch.config import TINY, from_cfg, tiny_config
from convofusion_tpu_torch.config.omega import OmegaConf
from convofusion_tpu_torch.models.convofusion import Convofusion, to_tensors
from convofusion_tpu_torch.serving import (
    GestureRequest,
    GestureService,
    ServiceOverloaded,
    build_service,
    serve_http,
)
from convofusion_tpu_torch.train.checkpoint import TRUNK, save_checkpoint

STEPS = 3
WAIT = 120          # seconds, any single blocking wait
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tiny shapes on one intra-op thread: beside the other
    test workers, OpenMP teams as wide as the machine wait on each other,
    and these steps took ~50x longer than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return Convofusion(TINY, device="cpu", seed=0)


def _req(i: int, **kw) -> GestureRequest:
    rng = np.random.default_rng(i)
    return GestureRequest(
        text_lsn=f"a nod about dragons {i}",
        text_spk=f"we talk about maps {i}",
        melspec=rng.uniform(-80, 0, (161, 80)).astype(np.float32),
        active_passive=rng.integers(0, 2, 8).astype(np.int32),
        lsn_id=int(rng.integers(1, 36)), **kw)


def _check_motion(m):
    assert m.shape == (128, 189) and m.dtype == np.float32
    assert np.isfinite(m).all()


class _Http:
    """A service behind serve_http on an ephemeral loopback port."""

    def __init__(self, svc):
        self.server = serve_http(svc, port=0)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        host, port = self.server.server_address[:2]
        self.url = f"http://{host}:{port}"

    def post(self, obj):
        req = urllib.request.Request(
            f"{self.url}/generate", data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            return json.loads(resp.read())

    def get(self, path):
        with urllib.request.urlopen(f"{self.url}{path}",
                                    timeout=WAIT) as resp:
            return json.loads(resp.read())

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=WAIT)
        assert not self.thread.is_alive()


def test_microbatching_and_occupancy(model):
    svc = GestureService(model, batch_size=4, max_wait_ms=300,
                         num_inference_steps=STEPS)
    try:
        futs = [svc.submit(_req(i)) for i in range(6)]
        motions = [f.result(timeout=WAIT) for f in futs]
        for m in motions:
            _check_motion(m)
        # 6 requests at batch 4: one full batch and one half batch
        st = svc.stats()
        assert st["requests"] == 6 and st["batches"] == 2
        assert st["occupancy"] == pytest.approx(6 / 8)
        assert np.isfinite(st["latency_p50_ms"])
        assert st["batch_ms_p50"] > 0
        assert st["text_only_passes"] == 0      # WEG off
        assert not np.allclose(motions[0], motions[1])
        svc.reset_stats()
        st = svc.stats()
        assert (st["requests"], st["batches"], st["occupancy"]) == (0, 0,
                                                                    0.0)
    finally:
        svc.close()


def test_single_request_and_validation(model):
    svc = GestureService(model, batch_size=4, max_wait_ms=5,
                         num_inference_steps=STEPS)
    try:
        # defaults: no mel (silence), no apb (idle), text only
        _check_motion(svc.generate(GestureRequest(text_lsn="hello there"),
                                   timeout=WAIT))
        with pytest.raises(ValueError, match="melspec"):
            svc.submit(GestureRequest(text_lsn="x",
                                      melspec=np.zeros((3, 3), np.float32)))
        with pytest.raises(ValueError, match="active_passive"):
            svc.submit(GestureRequest(text_lsn="x",
                                      active_passive=np.zeros(3, np.int32)))
        with pytest.raises(ValueError, match="weg"):
            svc.submit(GestureRequest(text_lsn="x", focus_words=("x",)))
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(GestureRequest(text_lsn="after close"))


def _gated(svc):
    """Hold the builder inside _build until the returned event is set."""
    gate = threading.Event()
    build = svc._build
    svc._build = lambda reqs: (gate.wait(WAIT), build(reqs))[1]
    return gate


def _wait_collected(svc):
    deadline = time.time() + 30
    while svc._q.qsize() and time.time() < deadline:
        time.sleep(0.01)
    assert svc._q.qsize() == 0, "builder never collected the batch"


def test_backpressure_rejects_when_full(model):
    """A full intake queue rejects with ServiceOverloaded, and through HTTP
    with 503 and Retry-After; accepted work still completes."""
    svc = GestureService(model, batch_size=2, max_wait_ms=5,
                         num_inference_steps=STEPS, max_queue=3)
    gate = _gated(svc)
    http = _Http(svc)
    try:
        futs = [svc.submit(_req(i)) for i in range(2)]
        _wait_collected(svc)          # the first batch waits in the builder
        futs += [svc.submit(_req(i)) for i in range(2, 5)]
        with pytest.raises(ServiceOverloaded, match="queue full"):
            svc.submit(_req(5))
        with pytest.raises(urllib.error.HTTPError) as err:
            http.post({"text": "one too many"})
        assert err.value.code == 503
        assert err.value.headers["Retry-After"] == "1"
        assert "queue full" in json.loads(err.value.read())["error"]
        st = svc.stats()
        assert st["rejected"] == 2 and st["queue_depth"] == 3
        gate.set()
        for f in futs:
            _check_motion(f.result(timeout=WAIT))
        assert svc.stats()["requests"] == 5
    finally:
        gate.set()
        http.close()
        svc.close()


def test_weg_service_routes_focus(model):
    """Each request's focus words reach the sampler as its own row's token
    columns; a request without focus words gets no valid column; the WEG
    path runs one text-only pass a step."""
    svc = GestureService(model, batch_size=2, max_wait_ms=2000,
                         num_inference_steps=STEPS, weg=True,
                         weg_max_focus=4)
    seen = []
    sampler = svc._sampler

    def spy(arrays, generator, focus=None):
        seen.append(focus)
        return sampler(arrays, generator, focus=focus)

    svc._sampler = spy
    try:
        futs = [svc.submit(_req(0, focus_words=("dragons", "nod"))),
                svc.submit(_req(1))]
        for f in futs:
            _check_motion(f.result(timeout=WAIT))
        st = svc.stats()
        assert st["batches"] == 1
        assert st["text_only_passes"] == STEPS
        assert st["refinement_iterations"] == 0
    finally:
        svc.close()
    (focus,) = seen
    # "<bos> a nod about dragons 0 <eos>": nod is token 2, dragons token 4
    np.testing.assert_array_equal(focus["focus_idx"][0], [4, 2, 0, 0])
    np.testing.assert_array_equal(focus["focus_valid"],
                                  [[1, 1, 0, 0], [0, 0, 0, 0]])


def test_update_params_invalidates_uncond():
    """A swap lands at the next micro-batch, loaded by the device thread,
    and the sampler re-encodes the uncond branch with the new weights: the
    served motion equals a fresh model's with those weights."""
    model = Convofusion(TINY, device="cpu", seed=0)
    svc = GestureService(model, batch_size=2, max_wait_ms=5,
                         num_inference_steps=STEPS, seed=5)
    try:
        m0 = svc.generate(_req(0), timeout=WAIT)
        version = model.weights_version
        new = {k: v * 1.05 if v.is_floating_point() else v
               for k, v in model.state_dict().items()}
        svc.update_params(new)
        assert model.weights_version == version   # not loaded yet
        m1 = svc.generate(_req(0), timeout=WAIT)
        assert model.weights_version == version + 1
        assert svc._sampler._version == model.weights_version
        assert not np.allclose(m0, m1)
    finally:
        svc.close()
    fresh = Convofusion(TINY, device="cpu", seed=None)
    fresh.load_state_dict(new)
    arrays, _ = svc._build([_req(0)])
    gen = torch.Generator().manual_seed(5)
    fresh.sample(to_tensors(arrays, "cpu"), gen, STEPS)    # batch 1's draws
    want, _ = fresh.sample(to_tensors(arrays, "cpu"), gen, STEPS)
    np.testing.assert_array_equal(m1, want[0].numpy())


def test_http_endpoint(model):
    svc = GestureService(model, batch_size=2, max_wait_ms=100,
                         num_inference_steps=STEPS)
    http = _Http(svc)
    try:
        results = [None, None]

        def go(i):
            results[i] = http.post({"text": f"hello dragon {i}",
                                    "lsn_id": i + 1})

        threads = [threading.Thread(target=go, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
            assert not th.is_alive()
        for r in results:
            assert r is not None and r["latency_ms"] > 0
            _check_motion(np.asarray(r["motion"], np.float32))
        assert http.get("/healthz")["ok"]
        assert http.get("/stats")["requests"] >= 2
        for obj in ({"text": "x", "melspec": [[0.0]]},
                    {"text": "x", "focus_words": ["x"]}):
            with pytest.raises(urllib.error.HTTPError) as err:
                http.post(obj)
            assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            http.get("/nope")
        assert err.value.code == 404
    finally:
        http.close()
        svc.close()


def test_close_serves_queued_requests(model):
    """close() lets every request queued before it through all three
    stages and stops the threads."""
    svc = GestureService(model, batch_size=2, max_wait_ms=5,
                         num_inference_steps=STEPS)
    futs = [svc.submit(_req(i)) for i in range(3)]
    svc.close(timeout=WAIT)
    for f in futs:
        _check_motion(f.result(timeout=0))
    assert not any(th.is_alive() for th in svc._threads)
    svc.close()   # a second close is a no-op


def test_close_fails_what_a_wedged_stage_holds(model):
    """With the builder wedged, close() gives up on the joins after its
    timeout and fails every future still queued, instead of leaving its
    caller blocked forever."""
    svc = GestureService(model, batch_size=1, max_wait_ms=5,
                         num_inference_steps=STEPS)
    gate = _gated(svc)
    try:
        futs = [svc.submit(_req(i)) for i in range(3)]
        deadline = time.time() + 30
        while svc._q.qsize() > 2 and time.time() < deadline:
            time.sleep(0.01)
        assert svc._q.qsize() == 2, "builder never took the first request"
        t0 = time.perf_counter()
        svc.close(timeout=0.2)
        assert time.perf_counter() - t0 < 10
        for f in futs[1:]:
            with pytest.raises(RuntimeError, match="service closed"):
                f.result(timeout=0)
    finally:
        gate.set()
    # the wedged request completes once released; then stop the threads
    _check_motion(futs[0].result(timeout=WAIT))
    svc._q.put(None)
    for th in svc._threads:
        th.join(timeout=WAIT)
        assert not th.is_alive()


def test_concurrent_clients(model):
    """More client threads than cores, with a short switch interval: every
    request is answered once, and the counters add up."""
    n_threads, per_thread = 2 * (os.cpu_count() or 1), 2
    svc = GestureService(model, batch_size=4, max_wait_ms=20,
                         num_inference_steps=1, max_queue=0)
    out, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(c):
            try:
                for k in range(per_thread):
                    out[(c, k)] = svc.generate(_req(c * per_thread + k),
                                               timeout=WAIT)
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
        svc.close()
    assert not errors
    assert len(out) == n_threads * per_thread
    for m in out.values():
        _check_motion(m)
    st = svc.stats()
    assert st["requests"] == n_threads * per_thread
    assert st["batches"] * 4 >= st["requests"]


def test_service_batch_equals_direct_sample(model):
    """A full micro-batch is bit-equal to a direct cached-sampler call over
    the same assembled arrays with the same generator state: batching adds
    routing, not math."""
    reqs = [_req(i) for i in range(4)]
    svc = GestureService(model, batch_size=4, max_wait_ms=2000,
                         num_inference_steps=STEPS, seed=123)
    try:
        futs = [svc.submit(r) for r in reqs]
        served = np.stack([f.result(timeout=WAIT) for f in futs])
    finally:
        svc.close()
    arrays, focus = svc._build(reqs)
    sampler = model.cached_sampler(num_inference_steps=STEPS)
    motion, _ = sampler(to_tensors(arrays, "cpu"),
                        torch.Generator().manual_seed(123), focus=focus)
    np.testing.assert_array_equal(served, motion.numpy())


def _tiny_cfg(**serve):
    cfg = copy.deepcopy(TINY)
    cfg["scheduler"]["num_inference_timesteps"] = STEPS
    cfg["serve"].update(serve)
    return cfg


def test_build_service_from_config():
    """build_service wires the serve block, the step count and the WEG
    flag; a checkpoint that is not there raises and names it; with no
    device it wants the card."""
    svc = build_service(_tiny_cfg(batch_size=2, max_wait_ms=30.0),
                        device="cpu")
    try:
        assert svc.batch_size == 2 and not svc.weg
        assert svc.max_wait == pytest.approx(0.03)
        assert svc.max_queue == 16
        assert svc._sampler.num_inference_steps == STEPS
        _check_motion(svc.generate(_req(0), timeout=WAIT))
    finally:
        svc.close()
    with pytest.raises(FileNotFoundError, match="model.ckpt"):
        build_service(_tiny_cfg(), device="cpu", checkpoint="model.ckpt")
    if torch.cuda.is_available():
        return      # the default device exists here
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_service(_tiny_cfg())


def test_cli_serves_http():
    """python -m convofusion_tpu_torch.serving on the CPU: it prints where
    it listens, answers POST /generate and GET /stats, and exits 0 on
    SIGINT; a checkpoint that is not there makes it fail."""
    cmd = [sys.executable, "-m", "convofusion_tpu_torch.serving",
           "--geometry", "tiny", "--device", "cpu", "--steps", "2",
           "--batch-size", "1", "--weg", "on", "--port", "0"]
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (
            line + proc.stderr.read() if proc.poll() is not None else line)
        assert "weg=True" in line and "cpu" in line
        url = line.split()[2]
        data = json.dumps({"text": "a nod about dragons",
                           "focus_words": ["dragons"]}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"{url}/generate", data=data), timeout=WAIT) as resp:
            _check_motion(np.asarray(json.loads(resp.read())["motion"],
                                     np.float32))
        with urllib.request.urlopen(f"{url}/stats", timeout=WAIT) as resp:
            st = json.loads(resp.read())
        assert st["requests"] == 1 and st["text_only_passes"] == 2
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=WAIT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
        proc.stdout.close()
        proc.stderr.close()
    res = subprocess.run(cmd + ["--checkpoint", "model.ckpt"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=WAIT)
    assert res.returncode != 0
    assert "model.ckpt" in res.stderr and "not found" in res.stderr


def _tiny_merged(**overrides):
    """tiny_config('diffusion') at STEPS DDIM steps, WEG as the experiment
    file has it ('semantic'), plus dotlist ``overrides``."""
    cfg = tiny_config("diffusion")
    extra = {"model.scheduler.variant": "ddim",
             "model.scheduler.num_inference_timesteps": STEPS, **overrides}
    return OmegaConf.merge(cfg, OmegaConf.from_dotlist(
        [f"{k}={v}" for k, v in extra.items()]))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The model of ``_tiny_merged()`` at seed 5 and its checkpoint."""
    source = Convofusion(from_cfg(_tiny_merged()), device="cpu", seed=5)
    path = save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), 3, source)
    return source, path


def test_build_service_from_a_checkpoint(saved):
    """A merged YAML config and a checkpoint: the service serves the
    checkpoint's weights (its live trunk drawn from its seed, 7) and a
    micro-batch equals sample() on the source model with the service's
    generator seed, once the source takes the service's trunk."""
    source, path = saved
    cfg = _tiny_merged(**{"SERVE.BATCH_SIZE": 2, "SERVE.MAX_WAIT_MS": 2000,
                          "SEED_VALUE": 7, "TEST.CHECKPOINTS": path})
    svc = build_service(cfg, device="cpu")
    reqs = [_req(0, focus_words=("dragons",)), _req(1)]
    try:
        assert svc.batch_size == 2 and svc.weg
        assert svc._sampler.num_inference_steps == STEPS
        live = Convofusion(from_cfg(cfg), device="cpu", seed=7)
        for k, v in svc.model.state_dict().items():
            want = live if k.startswith(TRUNK) else source
            assert torch.equal(v, want.state_dict()[k]), k
        futs = [svc.submit(r) for r in reqs]
        served = np.stack([f.result(timeout=WAIT) for f in futs])
    finally:
        svc.close()
    arrays, focus = svc._build(reqs)
    source.text_encoder.text_model.load_state_dict(
        live.text_encoder.text_model.state_dict())
    motion, _ = source.sample(to_tensors(arrays, "cpu"),
                              torch.Generator().manual_seed(7), STEPS,
                              focus=focus)
    np.testing.assert_array_equal(served, motion.numpy())
    # checkpoint= wins over TEST.CHECKPOINTS; a missing file raises
    with pytest.raises(FileNotFoundError, match="absent.ckpt"):
        build_service(cfg, device="cpu", checkpoint="absent.ckpt")


def test_cli_serves_from_cfg_and_checkpoint(tmp_path, saved):
    """python -m convofusion_tpu_torch.serving --cfg <tiny yaml> --device cpu
    --port 0 TEST.CHECKPOINTS=<path> starts and answers POST /generate."""
    _, path = saved
    tiny = tmp_path / "tiny.yaml"
    # the modules' YAMLs merge after the experiment file, so the same
    # file also goes in as the assets file, which merges last
    OmegaConf.save(tiny_config("diffusion"), str(tiny))
    cmd = [sys.executable, "-m", "convofusion_tpu_torch.serving",
           "--cfg", str(tiny), "--cfg_assets", str(tiny), "--device", "cpu",
           "--port", "0", "--batch-size", "1", "SERVE.MAX_WAIT_MS=5",
           "model.scheduler.variant=ddim",
           f"model.scheduler.num_inference_timesteps={STEPS}",
           f"TEST.CHECKPOINTS={path}"]
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (
            line + proc.stderr.read() if proc.poll() is not None else line)
        assert path in line and "weg=True" in line
        url = line.split()[2]
        data = json.dumps({"text": "a nod about dragons",
                           "focus_words": ["dragons"]}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"{url}/generate", data=data), timeout=WAIT) as resp:
            _check_motion(np.asarray(json.loads(resp.read())["motion"],
                                     np.float32))
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=WAIT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
        proc.stdout.close()
        proc.stderr.close()
    res = subprocess.run(cmd[:5] + ["--geometry", "tiny"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=WAIT)
    assert res.returncode != 0 and "exclude each other" in res.stderr
