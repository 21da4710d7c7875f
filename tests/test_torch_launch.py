"""The port's ``parallel/launch.py`` and ``parallel/mesh.py``: the
environment cases of ``tests/test_launch.py`` with ``torch.distributed``'s
``init_process_group`` recorded instead of run, the device and backend each
topology gets, a failed init raising (the deliberate difference from the JAX
function, which carries on alone), and the mesh's errors, those of the JAX
``make_mesh``, in a world of one."""

import pytest
import torch
import torch.distributed as dist

from lit_llama_tpu_torch.parallel import launch, mesh as mesh_lib

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class _InitRecorder:
    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail

    def __call__(self, backend, **kwargs):
        self.calls.append(dict(backend=backend, **kwargs))
        if self.fail:
            raise RuntimeError("no rendezvous reachable")


@pytest.fixture
def clean_launch(monkeypatch):
    """The module latch reset, the variables it reads scrubbed, and the
    process group's init recorded."""
    monkeypatch.setattr(launch, "_initialized", False)
    monkeypatch.setattr(launch, "_device", None)
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    rec = _InitRecorder()
    monkeypatch.setattr(dist, "init_process_group", rec)
    return rec


def _torchrun_env(monkeypatch, rank, world, local_rank=None, local_world=None):
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("LOCAL_RANK", str(rank if local_rank is None else local_rank))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(world if local_world is None else local_world))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")


@pytest.fixture
def cards(monkeypatch):
    """A host with ``n`` cards, as far as the launch can tell; the device it
    sets is recorded."""
    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)

    def with_cards(n):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        return chosen

    return with_cards


def test_no_torchrun_environment_returns_false(clean_launch):
    assert launch.maybe_initialize_distributed("cpu") is False
    assert clean_launch.calls == []
    assert launch.current_device() is None and launch.is_main_process()


def test_torchrun_environment_on_the_cpu(clean_launch, monkeypatch, capsys):
    """RANK / WORLD_SIZE / LOCAL_RANK and the rendezvous variables: gloo on
    the CPU, the env:// rendezvous, logged on stderr; the latch makes a
    second call a no-op."""
    _torchrun_env(monkeypatch, 1, 2)
    assert launch.maybe_initialize_distributed("cpu") is True
    assert clean_launch.calls == [dict(backend="gloo", init_method="env://", rank=1, world_size=2)]
    assert launch.current_device() == torch.device("cpu")
    err = capsys.readouterr().err
    assert "rank 1/2" in err and "device cpu, backend gloo" in err
    assert launch.maybe_initialize_distributed("cpu") is False
    assert len(clean_launch.calls) == 1
    assert not launch.is_main_process()


@pytest.mark.parametrize("n_cards,local_rank,device,backend", [
    (2, 1, "cuda:1", "nccl"),  # a card a rank
    (8, 1, "cuda:1", "nccl"),
    (1, 1, "cuda:0", "gloo"),  # two ranks share the one card: NCCL refuses them
])
def test_device_and_backend_follow_the_topology(clean_launch, monkeypatch, cards, n_cards, local_rank, device,
                                                backend):
    chosen = cards(n_cards)
    _torchrun_env(monkeypatch, local_rank, 2)
    assert launch.maybe_initialize_distributed() is True
    assert clean_launch.calls[0]["backend"] == backend
    assert launch.current_device() == torch.device(device) and chosen == [torch.device(device)]


def test_cards_that_do_not_share_out_evenly_raise(clean_launch, monkeypatch, cards):
    cards(3)
    _torchrun_env(monkeypatch, 0, 4)
    with pytest.raises(ValueError, match="4 local ranks on 3 cards"):
        launch.maybe_initialize_distributed()
    assert clean_launch.calls == []


def test_a_rank_that_asks_for_a_card_and_finds_none_raises(clean_launch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _torchrun_env(monkeypatch, 0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.maybe_initialize_distributed()


def test_init_failure_raises(monkeypatch, clean_launch):
    """Where the JAX function prints and carries on alone, a rank of the port
    raises: alone it would serve its shard of the weights as the model."""
    rec = _InitRecorder(fail=True)
    monkeypatch.setattr(dist, "init_process_group", rec)
    _torchrun_env(monkeypatch, 0, 2)
    with pytest.raises(RuntimeError, match="does not carry on alone"):
        launch.maybe_initialize_distributed("cpu")
    assert len(rec.calls) == 1 and launch._initialized is False


def test_rank_without_world_size_raises(clean_launch, monkeypatch):
    """RANK without WORLD_SIZE is a launch error, not a world of one."""
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(KeyError):
        launch.maybe_initialize_distributed("cpu")


def test_require_ranks_names_the_flag_and_torchrun(clean_launch, monkeypatch):
    with pytest.raises(NotImplementedError, match="model_parallel=2 needs a world of 2 ranks.*multi-device"):
        launch.require_ranks(2, "model_parallel")
    _torchrun_env(monkeypatch, 0, 2)
    launch.require_ranks(2, "model_parallel")


@pytest.fixture
def world_of_one(monkeypatch):
    monkeypatch.setattr(launch, "_initialized", False)
    monkeypatch.setattr(launch, "_device", None)
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_in_a_world_of_one(world_of_one):
    """make_mesh's errors are JAX's; a 1 x 1 mesh has the data and model
    axes, model innermost."""
    with pytest.raises(ValueError, match="mesh 1x2 != 1 devices"):
        mesh_lib.make_mesh(data=1, model=2, device="cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by model=3"):
        mesh_lib.make_mesh(data=-1, model=3, device="cpu")
    m = mesh_lib.make_mesh(device="cpu")
    assert m.mesh_dim_names == ("data", "model") and mesh_lib.mesh_shape(m) == (1, 1)
    assert mesh_lib.coordinate(m) == (0, 0) and mesh_lib.model_group(m) is None
    assert mesh_lib.mesh_shape(mesh_lib.single_device_mesh()) == (1, 1)
    assert mesh_lib.mesh_shape(None) == (1, 1) and launch.current_device() == torch.device("cpu")
