"""The port's sharding rules against the reference's, on the CPU.

The rules are pure functions of a mesh's ``shape`` and ``axis_names``, so
both packages are called with one stand-in mesh object (no device) for
the production meshes (16, 16) and (2, 16, 16) and a host-sized (4, 2):

* ``param_spec`` of every parameter of every registered architecture at
  its FULL configuration (the reference's tree from ``jax.eval_shape``,
  the port's as meta tensors; nothing is allocated), with and without
  FSDP, and ``params_shardings`` as a tree;
* ``batch_spec`` for 1-4 dims, with and without ``seq_shard``;
* ``cache_spec`` of every cache of every architecture at a decode shape,
  batch-sharded or not;
* ``validate_mesh_for`` gives the reference's problem lists (the
  reference's on an ``AbstractMesh`` of the same shape).

Placement (``place``, ``elastic.reshard``) works on a mesh of one device
and refuses a mesh of more (still to port, ROADMAP #5).
"""
import functools
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from test_torch_train_loss import leaves  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import elastic as ref_elastic  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.distributed import elastic, sharding  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model"))]


def stand_in(sizes, names):
    return types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                 axis_names=names)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """{path: shape} of the reference's parameters and decode caches (128
    rows of 4096 tokens), and the port's, at the full configuration."""
    rcfg, cfg = ref_config(arch), get_config(arch)
    rp = jax.eval_shape(lambda: RM.init_params(rcfg, jax.random.PRNGKey(0)))
    rc = jax.eval_shape(lambda: RM.init_caches(rcfg, 128, 4096,
                                               jnp.bfloat16))
    tp = TM.init_params(cfg, None)
    tc = TM.init_caches(cfg, 128, 4096, torch.bfloat16, device="meta")

    def shapes(tree):
        return {k[1:]: tuple(v.shape) for k, v in leaves(tree).items()}
    return shapes(rp), shapes(rc), shapes(tp), shapes(tc)


@pytest.mark.parametrize("arch", sorted(list_archs()))
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: str(m[0]))
def test_param_and_cache_specs_equal_the_reference(arch, mesh_shape):
    mesh = stand_in(*mesh_shape)
    ref_p, ref_c, port_p, port_c = _trees(arch)
    assert port_p == ref_p and port_c == ref_c
    for fsdp in (True, False):
        for path, shape in ref_p.items():
            want = tuple(ref_sharding.param_spec(path, shape, mesh,
                                                 fsdp=fsdp))
            assert sharding.param_spec(path, shape, mesh, fsdp=fsdp) \
                == want, (path, fsdp)
    for batch_sharded in (True, False):
        for path, shape in ref_c.items():
            want = tuple(ref_sharding.cache_spec(mesh, path, shape,
                                                 batch_sharded))
            assert sharding.cache_spec(mesh, path, shape, batch_sharded) \
                == want, (path, batch_sharded)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: str(m[0]))
def test_batch_specs_and_spec_trees_equal_the_reference(mesh_shape):
    mesh = stand_in(*mesh_shape)
    for ndim in (1, 2, 3, 4):
        for seq in (False, True):
            if seq and ndim < 2:
                continue
            assert sharding.batch_spec(mesh, ndim, seq) == tuple(
                ref_sharding.batch_spec(mesh, ndim, seq))
    # the trees: the spec of each leaf under its own path
    amesh = AbstractMesh(*mesh_shape)
    cfg = get_config("deepseek-v3-671b")
    ref_tree = jax.eval_shape(lambda: RM.init_params(
        ref_config("deepseek-v3-671b"), jax.random.PRNGKey(0)))
    want = jax.tree.map(lambda s: tuple(s.spec),
                        ref_sharding.params_shardings(ref_tree, amesh))
    got = sharding.params_shardings(TM.init_params(cfg, None), mesh)
    assert _spec_leaves(got) == _spec_leaves(want)
    caches = TM.init_caches(cfg, 8, 64, device="meta")
    got = sharding.cache_shardings(mesh, caches, batch_sharded=False)
    shape = tuple(caches["dense_layers"]["c_kv"].shape)
    assert _spec_leaves(got)["dense_layers/c_kv"] == sharding.cache_spec(
        mesh, "dense_layers/c_kv", shape, False)


def _spec_leaves(tree, prefix=""):
    """{path: spec} of a tree whose leaves are spec tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_spec_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b",
                                  "zamba2-2.7b", "xlstm-125m"])
def test_validate_mesh_for_equals_the_reference(arch):
    ref_tree = jax.eval_shape(lambda: RM.init_params(
        ref_config(arch), jax.random.PRNGKey(0)))
    tree = TM.init_params(get_config(arch), None)
    for sizes, names in MESHES + [((3, 5), ("data", "model"))]:
        want = ref_elastic.validate_mesh_for(ref_tree,
                                             AbstractMesh(sizes, names))
        assert elastic.validate_mesh_for(tree, stand_in(sizes, names)) \
            == want


def test_place_and_reshard_on_one_device_only():
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    state = {"w": torch.ones(4, 4), "layers": [torch.zeros(2)]}
    moved = elastic.reshard(state, mesh)
    assert torch.equal(moved["w"], state["w"])
    assert moved["layers"][0].device.type == "cpu"
    assert sharding.path_str(("layers", 0, "wq")) == "layers/0/wq"
    devs = np.empty(2, dtype=object)
    devs[:] = [torch.device("cpu")] * 2
    two = Mesh(devs.reshape(2, 1), ("data", "model"))
    with pytest.raises(NotImplementedError, match="#5"):
        elastic.reshard(state, two)
