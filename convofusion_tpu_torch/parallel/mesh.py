"""Data parallelism over ``torch.distributed``: one process a device.

Counterpart of ``convofusion_tpu/parallel/mesh.py`` and of the multi-host
parts of JAX's CLIs (``cli/train.py:43-86``, ``cli/test.py:61-87,176-190``,
``cli/unbounded.py:250-256``).  JAX shards the global batch over a
('data', 'model') mesh and XLA inserts the gradient ``psum``; here torchrun
starts one process a card, each process holds a replica and its share of the
batch, and :func:`all_reduce_mean` averages the gradients in one flattened
fp32 bucket (``train/trainer.py``).

* :func:`init_distributed` joins the group torchrun describes (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) under
  ``TPU.MULTIHOST: true``: NCCL on ``cuda:{LOCAL_RANK}``, gloo under
  ``--device cpu``, and beside it a gloo side group for host coordination
  (barriers, the preemption flag, validation means), which never touches
  the card.  It raises, naming what is missing, without torchrun's
  environment, and raises on ``WORLD_SIZE`` > 1 with ``MULTIHOST`` off:
  N processes would train N divergent models and race on the checkpoint
  directory (JAX's ``cli/train.py:68-77`` guards the same case).
* :func:`process_barrier` waits on the side group with a timeout, as JAX's
  waits on the coordination service rather than a device collective.
* :func:`local_data_parallel` answers "no sharding" with one process a
  device, as JAX does on one chip; :func:`local_device_count` is 1.
* :func:`create_mesh` lays the group out as JAX's (n_data, n_model)
  ('data', 'model') mesh (``convofusion_tpu/parallel/mesh.py:20-29``): a
  ``torch.distributed`` DeviceMesh whose model rows are consecutive ranks,
  as JAX reshapes its device list.  It becomes the process's layout:
  :func:`data_rank`, :func:`data_size`, :func:`local_rows`,
  :func:`mask_generator` and :func:`all_reduce_mean` then answer for the
  'data' axis alone, and ``parallel/tp.py`` splits the parameters over
  'model'.  Without a mesh the data axis is the whole group.
* JAX's ``compile_synced`` has no counterpart: nothing is compiled ahead of
  a step, so no rank can wait on another's compile.

Randomness under a group: each step's draws (noise, timesteps, VAE eps,
modality-dropout groups) are drawn for the global batch from a generator
every rank shares, and each data rank keeps its rows (:func:`local_rows`),
so the ranks' work together is one process's work on the global batch.
Layer dropout masks (``ops/layers.Dropout``, the T5 trunk's too) come from
a stream of each data rank's own (:func:`mask_generator`), seeded from the
seed and the data rank: drawing them at the global batch and keeping a
slice would double that work.  The model ranks of one data row share that
stream, so the activations they all hold stay equal.  With one data rank
nothing changes: the masks come from the loss's generator.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
DEFAULT_TIMEOUT_S = 1800.0

# the gloo side group of the process's group, set by init_distributed, and
# the process's ('data', 'model') layout, set by create_mesh
_STATE: Dict = {"side": None, "mesh": None}
# the per-rank dropout streams by device, and their seed
_MASKS: Dict = {"seed": None, "streams": {}}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def create_mesh(n_data: int = -1, n_model: int = 1, device=None):
    """The live group as an (n_data, n_model) DeviceMesh named ('data',
    'model'), rank ``d * n_model + m`` at (d, m); ``n_data`` -1 takes the
    rest of the world.  ``device``: the mesh's device type, by default the
    group's ('cuda' under NCCL, else 'cpu').  The mesh becomes this
    process's layout until :func:`shutdown`.  Raises without a group and
    on a world that does not factor."""
    from torch.distributed.device_mesh import init_device_mesh

    if not is_initialized():
        raise RuntimeError("create_mesh needs a live torch.distributed group "
                           "(init_distributed, or torchrun's)")
    n = world_size()
    if n_data == -1 and n_model >= 1:
        n_data = n // n_model
    if n_model < 1 or n_data < 1 or n_data * n_model != n:
        raise ValueError(f"{n} ranks cannot form a ({n_data}, {n_model}) "
                         f"mesh")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    layout = init_device_mesh(torch.device(device).type, (n_data, n_model),
                              mesh_dim_names=("data", "model"))
    _STATE["mesh"] = layout
    return layout


def data_rank() -> int:
    """This process's index on the 'data' axis (its rank without a
    mesh)."""
    layout = _STATE["mesh"]
    return layout.get_local_rank("data") if layout is not None else rank()


def data_size() -> int:
    """The 'data' axis' length (the world without a mesh)."""
    layout = _STATE["mesh"]
    return layout.size(0) if layout is not None else world_size()


def data_group():
    """The group of this rank's 'data' axis (None: the whole world)."""
    layout = _STATE["mesh"]
    return layout.get_group("data") if layout is not None else None


def is_main() -> bool:
    """Process 0 writes the side outputs (metrics, wandb, checkpoints)."""
    return rank() == 0


def init_distributed(cfg, device=None) -> Optional[torch.device]:
    """Join the group of ``TPU.MULTIHOST: true`` and return this rank's
    device (``device`` unchanged without it).  Returns after the group
    exists; :func:`shutdown` leaves it."""
    tpu = cfg.get("TPU", {}) or {}
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if not bool(tpu.get("MULTIHOST", False)):
        if env_world > 1:
            raise ValueError(
                f"WORLD_SIZE={env_world} but TPU.MULTIHOST is off: each "
                f"process would train its own model and race on the "
                f"checkpoint directory; pass TPU.MULTIHOST=true")
        return None if device is None else torch.device(device)
    missing = [k for k in ENV if not os.environ.get(k)]
    if missing:
        raise RuntimeError(
            f"TPU.MULTIHOST=true needs torchrun's environment: "
            f"{', '.join(missing)} unset (run under torchrun, or set them)")
    if is_initialized():
        raise RuntimeError("a torch.distributed group already exists")
    r, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("TPU.MULTIHOST on the card needs CUDA; pass "
                               "--device cpu for gloo on the host")
        dev, backend = torch.device(f"cuda:{local}"), "nccl"
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                    f"{os.environ['MASTER_PORT']}",
        world_size=world, rank=r, timeout=timeout)
    _STATE["side"] = dist.new_group(backend="gloo", timeout=timeout)
    return dev


def shutdown() -> None:
    """Leave the group (no-op without one) and forget the mesh and the mask
    streams."""
    if is_initialized():
        dist.destroy_process_group()
    _STATE.update(side=None, mesh=None)
    _MASKS.update(seed=None, streams={})


def process_barrier(name: str, timeout_s: float = DEFAULT_TIMEOUT_S
                    ) -> None:
    """Block until every rank reaches the barrier ``name``, on the gloo
    side group (host only; a rank that does not come within ``timeout_s``
    raises on the others).  No-op without a group."""
    if not is_initialized():
        return
    dist.monitored_barrier(group=_STATE["side"],
                           timeout=datetime.timedelta(seconds=timeout_s),
                           wait_all_ranks=True)


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any, reduced on the
    side group (no device sync)."""
    if not is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_STATE["side"])
    return bool(t.item())


def host_mean(values: Dict[str, float]) -> Dict[str, float]:
    """Each value averaged over the ranks on the side group (every rank
    passes the same keys)."""
    if not is_initialized() or not values:
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(t, group=_STATE["side"])
    t /= world_size()
    return dict(zip(keys, t.tolist()))


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors averaged over the data ranks, in fp32: one flattened
    bucket, one collective over the 'data' axis.  The results are fp32
    views of the bucket.  Without a group, the tensors in fp32."""
    tensors = [t.detach().float() for t in tensors]
    if not is_initialized():
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=data_group())
    flat.div_(data_size())
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def local_rows(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's rows of a global-batch tensor along ``axis``: the
    ``data_rank``-th of ``data_size`` equal blocks."""
    world = data_size()
    if world == 1:
        return x
    n = x.shape[axis] // world
    return x.narrow(axis, data_rank() * n, n)


def rank_seed(seed: int, r: Optional[int] = None) -> int:
    """A seed for data rank ``r`` (this one by default) from ``seed``:
    ``seed`` itself for rank 0."""
    r = data_rank() if r is None else r
    return (int(seed) + r * 0x9E3779B97F4A7C15) % (1 << 63)


def seed_mask_streams(seed: int) -> None:
    """Restart this rank's dropout streams from ``seed`` and the rank (the
    train CLI does at each epoch, so a resumed run draws what a straight
    one does)."""
    _MASKS.update(seed=int(seed), streams={})


def mask_generator(generator: Optional[torch.Generator], device
                   ) -> Optional[torch.Generator]:
    """The generator a loss's dropout masks draw from: ``generator`` with
    one data rank; with several, this data rank's own stream on ``device``,
    seeded by :func:`seed_mask_streams` (else from ``generator``'s initial
    seed) and the data rank, so that the shared ``generator`` advances
    alike on every rank."""
    if data_size() == 1:
        return generator
    device = torch.device(device)
    key = (device.type, device.index)
    stream = _MASKS["streams"].get(key)
    if stream is None:
        base = _MASKS["seed"]
        if base is None:
            base = 0 if generator is None else generator.initial_seed()
        stream = torch.Generator(device=device).manual_seed(rank_seed(base))
        _MASKS["streams"][key] = stream
    return stream


def check_batch_sizes(train_batch: int, eval_batch: Optional[int]) -> None:
    """JAX's batch-size checks under a group (``cli/train.py:55-86``):
    ``TRAIN.BATCH_SIZE`` and, with validation on (``eval_batch`` not
    None), ``EVAL.BATCH_SIZE`` divisible by the local devices.  With one
    device a process any positive size passes."""
    if world_size() == 1:
        return
    n = local_device_count()
    for key, size in (("TRAIN.BATCH_SIZE", train_batch),
                      ("EVAL.BATCH_SIZE", eval_batch)):
        if size is not None and (size < 1 or size % n):
            raise ValueError(f"data-parallel training needs {key} divisible "
                             f"by the {n} local devices; got {size}")


def local_device_count() -> int:
    """The devices this process drives: one (torchrun starts a process a
    card)."""
    return 1


def local_data_parallel(batch_size: int) -> Tuple[None, int]:
    """JAX's single-host data parallelism over the local chips, for the
    inference CLIs: (sharding or None, local devices).  With one process a
    device the answer is always (None, 1): no sharding, as JAX answers on
    one chip; ranks of a group each sample the whole batch."""
    del batch_size
    return None, local_device_count()
