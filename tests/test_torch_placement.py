"""Placement of the language-model stack over a process group's mesh.

* (a) For every leaf of all ten configs' ``--reduced`` parameters, on
  (2, 2), (4, 1) and (1, 4), ``spec_placements`` of the port's spec is
  the reference's ``params_shardings`` spec read as DTensor placements:
  ``Shard(d)`` on each mesh axis that the spec names at dim ``d``,
  ``Replicate()`` elsewhere and on an axis of size 1 (a shard of one is
  the whole). A pure mapping, no processes.
* (b) Four gloo processes on a (2, 2) mesh, launched as a user launches
  them (``python -m torch.distributed.run``), on the reference's
  parameters carried over by ``params_from_numpy``, float32 compute:
  - the gradients of a train step (``remat="dots"``) of qwen3-0.6b and of
    moonshot-v1-16b-a3b with the activation policy set: the loss within
    1e-5 and every gradient leaf within 1e-4 of its largest magnitude,
    against the port's one-device step (plain tensors, the same policy:
    moonshot's MoE dispatch runs in two groups there too) and against the
    reference's sharded step (four forced host devices, a
    ``jax.sharding.Mesh`` with Auto axes, parameters placed by its
    ``params_shardings``); the same for ``qwen3-0.6b-tp``, qwen3-0.6b's
    reduced config at widths whose projections the rules split over the
    model axis (d_model 256, head dim 64, d_ff 256: at the reduced widths
    every leaf is under the rules' 2^16-element floor and replicated),
    for ``moonshot-v1-16b-a3b-ep`` and ``deepseek-v3-671b-tp``, one
    dense and one MoE layer at widths where the router, the expert and
    shared-expert stacks and (deepseek) every MLA projection split, and
    for ``xlstm-125m-tp`` (d_model 128) and ``zamba2-2.7b-tp`` (d_model
    256, 8 heads of 32, d_ff 256), where the mLSTM stack's ``w_up``,
    ``wq``/``wk``/``wv`` and ``w_down`` split, and zamba2's ``in_proj``
    (its shard boundary, 544 of 1088 columns, inside ``x``),
    ``out_proj`` and every projection of its shared block;
  - the MoE cases' experts on their expert-parallel shards: E/4 a card
    while the layer runs, no expert stack gathered (nor its gradient
    reduce-scattered) on any axis, the tokens moved by all-to-alls over
    the data axis; MLA's ``wq_b``/``wkv_b``/``wo`` shards half their
    model-axis dim; a placed float32 prefill and two decode steps of the
    MLA case and of the two SSM cases within 1e-5 of the plain ones;
  - the SSM cases' split projections (mLSTM's ``wq``/``wk``/``wv`` and
    ``w_down``, mamba2's ``out_proj``, the shared block's) keep half
    their model-axis dim on each card while their layer runs;
  - that step's collectives (``launch.dryrun.CollectiveCounter``): no
    all-gather over the model axis but the label pick's logits (so none
    of a split projection), two all-reduces over the model axis a layer
    in the forward (attention's and the MLP's row-parallel sums) and the
    vocab-parallel embedding's one, and every split projection's local
    shard half its model-axis dim and whole on the other while its layer
    runs;
  - the grouped MoE dispatch (g = 2, capacity factor 1.0) within 1e-5 of
    the largest value of the reference's grouped dispatch, and the dense
    dispatch on placed parameters within 1e-5 of its plain result;
  - a checkpoint written on (2, 2) restores on (2, 2), on (4, 1) and on
    one device with every leaf equal, and the loss of the resumed step
    replays the uninterrupted run's bit for bit on each (the token
    losses are summed whole on every process);
  - ``reshard`` from (2, 2) to (4, 1) keeps every full tensor.
* (c) ``python -m torch.distributed.run --standalone --nproc-per-node 4
  -m repro_torch.launch.train --arch qwen3-0.6b --reduced --device cpu
  --model-parallel 2 --steps 2`` prints the ``[train]`` line once, and
  its first loss equals the one-process run's within 1e-5. The second
  is held within 1e-4: in bfloat16 compute each data shard's weight
  gradient is rounded to bfloat16 before the cross-shard sum, where one
  process rounds the whole sum once, and Adam's first step turns a
  gradient near zero that takes the other sign into a move of 2·lr
  (5.6e-5 measured on the CPU).
* (d) On (2, 16, 16) and (16, 16), for E = 64 and 256, the placed
  dispatch's buffers split E over the axes the rules give the expert
  stacks (``sharding.expert_axes``). A pure mapping, no processes.

The reference's figures, (b)'s processes and (c)'s run are three
subprocesses started together; the one-device figures are computed here
meanwhile.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from test_torch_train_loss import (leaves, make_batch,  # noqa: E402
                                   ref_params, rel)

from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.train.train_step import (remat_loss_fn,  # noqa: E402
                                          value_and_grad)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-0.6b", "moonshot-v1-16b-a3b", "qwen3-0.6b-tp",
         "moonshot-v1-16b-a3b-ep", "deepseek-v3-671b-tp", "xlstm-125m-tp",
         "zamba2-2.7b-tp")
# cases beyond the registered reduced configs: (arch, widths replaced).
# At the MoE cases' widths the router, the expert stacks, the shared
# experts and (deepseek) every MLA projection reach the rules' 2^16
# elements, E divides the (2, 2) mesh's four cards and the heads its
# model axis; one dense layer and one MoE layer each
WIDE = {"qwen3-0.6b-tp": ("qwen3-0.6b",
                          dict(d_model=256, head_dim=64, d_ff=256)),
        "moonshot-v1-16b-a3b-ep": ("moonshot-v1-16b-a3b", dict(
            n_layers=2, d_model=512, head_dim=32, n_experts=128,
            moe_d_ff=64)),
        "deepseek-v3-671b-tp": ("deepseek-v3-671b", dict(
            n_layers=2, d_model=1024, n_heads=8, n_kv_heads=8, d_ff=64,
            n_experts=64, moe_d_ff=64, q_lora_rank=64, kv_lora_rank=64,
            qk_nope_dim=96, rope_dim=32, v_head_dim=32)),
        # the SSM and hybrid families at widths the rules split over the
        # model axis (the reduced ones fall under the 2^16 floor)
        "xlstm-125m-tp": ("xlstm-125m", dict(d_model=128)),
        "zamba2-2.7b-tp": ("zamba2-2.7b", dict(
            d_model=256, head_dim=32, n_heads=8, n_kv_heads=8, d_ff=256))}
EP = ("moonshot-v1-16b-a3b-ep", "deepseek-v3-671b-tp")
SSM = ("xlstm-125m-tp", "zamba2-2.7b-tp")
# the cases whose placed prefill and decode steps are held to the plain
SERVED = ("deepseek-v3-671b-tp",) + SSM
# the split projections and the tensor dim each splits over the model axis
SPLIT = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1,
         "w_down": 0}
# MLA's projections split on whole heads
SPLIT_MLA = {"wq_b": 1, "wkv_b": 1, "wo": 0}
# the SSM cases' split projections: mLSTM's (its packed ``w_up`` too),
# mamba2's row-parallel ``out_proj`` and the shared block's
SPLIT_SSM = dict(SPLIT, out_proj=0)
# the ones each SSM case must show
SPLIT_SHOWN = {"xlstm-125m-tp": {"w_up", "wq", "wk", "wv", "w_down"},
               "zamba2-2.7b-tp": set(SPLIT_SSM)}
B, S = 4, 16
MOE = dict(d_model=64, d_ff=32, n_experts=8, k=2, tokens=(4, 16))
F32_LOSS, F32_GRAD, MOE_TOL = 1e-5, 1e-4, 1e-5
TIMEOUT = 300


def stand_in(sizes, names=("data", "model")):
    devs = np.empty(int(np.prod(sizes)), dtype=object)
    devs[:] = [torch.device("meta")] * devs.size
    return Mesh(devs.reshape(sizes), names)


def cfg_of(name, getter):
    """The reduced config of case ``name`` from ``getter`` (the port's or
    the reference's ``get_config``), at its ``WIDE`` widths."""
    arch, widths = WIDE.get(name, (name, {}))
    return dataclasses.replace(getter(arch, reduced=True), **widths)


def ref_tree(name):
    """The reference's parameters of case ``name`` as numpy."""
    if name not in WIDE:
        return ref_params(name)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(
        RM.init_params, cfg_of(name, ref_config)))(jax.random.PRNGKey(0)))


# -- (a) placements follow the reference's specs ------------------------------

def _axis_placement(spec, axis, size):
    for d, e in enumerate(spec):
        if size > 1 and (e == axis or (isinstance(e, tuple) and axis in e)):
            return ("shard", d)
    return ("replicate",)


def _kind(p):
    return ("shard", p.dim) if p.is_shard() else (
        ("replicate",) if p.is_replicate() else (str(p),))


@pytest.mark.parametrize("sizes", [(2, 2), (4, 1), (1, 4)], ids=str)
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_placements_follow_the_reference_specs(arch, sizes):
    rtree = leaves(jax.eval_shape(lambda: RM.init_params(
        ref_config(arch, reduced=True), jax.random.PRNGKey(0))))
    tree = leaves(TM.init_params(get_config(arch, reduced=True), None))
    assert rtree.keys() == tree.keys()
    amesh, mesh = AbstractMesh(sizes, ("data", "model")), stand_in(sizes)
    for path, leaf in tree.items():
        want = tuple(ref_sharding.param_spec(path[1:], rtree[path].shape,
                                             amesh))
        got = sharding.spec_placements(
            sharding.param_spec(path[1:], tuple(leaf.shape), mesh), mesh)
        assert [_kind(p) for p in got] == [
            _axis_placement(want, a, n) for a, n in zip(mesh.axis_names,
                                                        sizes)], path


# -- (b), (c): the processes ---------------------------------------------------

REF_SCRIPT = """
import dataclasses, functools, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.models import model as RM, moe as ref_moe
inp = dict(np.load(sys.argv[1]))
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
shd.set_activation_policy(mesh)
out = {}
def cfg_of(name):
    arch, widths = @WIDE@.get(name, (name, {}))
    return dataclasses.replace(get_config(arch, reduced=True), **widths)
for arch in @ARCHS@:
    cfg = dataclasses.replace(cfg_of(arch), compute_dtype="float32")
    params = jax.jit(functools.partial(RM.init_params, cfg_of(arch)))(
        jax.random.PRNGKey(0))
    params = jax.device_put(params, shd.params_shardings(params, mesh))
    batch = {k: inp[f"{arch}/batch/{k}"] for k in ("tokens", "labels")}
    batch = jax.device_put(batch, shd.batch_shardings(mesh, batch))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(cfg, p, b, remat="dots")))(params, batch)
    out[f"{arch}/loss"] = np.asarray(loss)
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"{arch}/grad/" + shd.path_str(path)] = np.asarray(g)
p = ref_moe.init_moe(jax.random.PRNGKey(1), @D_MODEL@, @D_FF@, @N_EXPERTS@)
x = jnp.asarray(inp["moe/x"])
y = jax.jit(lambda p, x: ref_moe.moe_sam_dispatch(
    p, x, k=@K@, capacity_factor=1.0, compute_dtype=jnp.float32))(p, x)
out["moe/y"] = np.asarray(y)
out["moe/group_size"] = np.asarray(shd.data_group_size())
for k, v in p.items():
    out[f"moe/p/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""

RANK_SCRIPT = """
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.distributed import elastic, sharding as S
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.distributed.fault_tolerance import TrainingRunner
from repro_torch.launch import train
from repro_torch.launch.dryrun import CollectiveCounter
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import model as M, moe
from repro_torch.models.common import params_from_numpy
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import (make_train_step, remat_loss_fn,
                                          value_and_grad)
inp = dict(np.load(sys.argv[1]))
assert train.start_process_group("cpu")
rank = dist.get_rank()
mesh22, mesh41 = make_host_mesh(2, device="cpu"), make_host_mesh(1, device="cpu")
out = {}

def cfg_of(name):
    arch, widths = @WIDE@.get(name, (name, {}))
    return dataclasses.replace(get_config(arch, reduced=True), **widths)

def tree_of(arch):
    cfg = dataclasses.replace(cfg_of(arch), compute_dtype="float32")
    flat = {k[len(arch) + 7:]: v for k, v in inp.items()
            if k.startswith(arch + "/param/")}
    tree = S.map_with_path(lambda path, _: flat["/".join(map(str, path))],
                           M.init_params(cfg, None))
    batch = {k: torch.tensor(inp[f"{arch}/batch/{k}"]) for k in ("tokens", "labels")}
    return cfg, params_from_numpy(tree, device="cpu"), batch

def put(mesh, params, batch):
    return S.place(params, mesh), S.place(batch, mesh, S.batch_shardings(mesh, batch))

S.set_activation_policy(mesh22)
for arch in @ARCHS@:
    cfg, params, batch = tree_of(arch)
    dp, db = put(mesh22, params, batch)
    if arch in @WIDE@:
        # the split layer's collectives and local shards (the projections'
        # where a layer gathers them, the MoE blocks' as they run)
        shards, gather, gather_moe = [], M.gathered_over_data, M.gathered_but_experts

        def watch(tag, fn):
            def watched(tree):
                res = fn(tree)
                S.map_with_path(lambda path, t: shards.append((
                    tag + str(path[-1]), tuple(t.shape),
                    tuple(t.to_local().shape))) if path and str(path[-1])
                    in @WATCH@ else None, res)
                return res
            return watched
        M.gathered_over_data = watch("", gather)
        M.gathered_but_experts = watch("moe/", gather_moe)
        with CollectiveCounter(mesh22.device_mesh) as fwd:
            M.loss_fn(cfg, dp, db, remat="dots")
        with CollectiveCounter(mesh22.device_mesh) as step:
            loss, grads = value_and_grad(remat_loss_fn(cfg, "dots"), dp, db)
        M.gathered_over_data, M.gathered_but_experts = gather, gather_moe
        out[f"{arch}/fwd"] = np.asarray(fwd.records, dtype=object)
        out[f"{arch}/step"] = np.asarray(step.records, dtype=object)
        out[f"{arch}/shards"] = np.asarray(shards, dtype=object)
    else:
        loss, grads = value_and_grad(remat_loss_fn(cfg, "dots"), dp, db)
    out[f"{arch}/loss"] = S.full_tensors(loss).numpy()
    S.map_with_path(lambda path, g: out.__setitem__(
        f"{arch}/grad/" + "/".join(map(str, path)),
        g.full_tensor().numpy()), grads)
    out[f"{arch}/placed"] = np.asarray([isinstance(t, DTensor) for t in M.tree_leaves(dp)]).all()

# the SSM cases again with their packed products by the weight path (at
# these token counts the activation path moves fewer bytes)
packed_path, S.packed_path = S.packed_path, lambda *a: "weight"
for arch in @SSM@:
    cfg, params, batch = tree_of(arch)
    dp, db = put(mesh22, params, batch)
    loss, grads = value_and_grad(remat_loss_fn(cfg, "dots"), dp, db)
    out[f"weight-path/{arch}/loss"] = S.full_tensors(loss).numpy()
    S.map_with_path(lambda path, g: out.__setitem__(
        f"weight-path/{arch}/grad/" + "/".join(map(str, path)),
        g.full_tensor().numpy()), grads)
S.packed_path = packed_path

# the grouped MoE dispatch on a data-sharded DTensor
p = params_from_numpy({k[6:]: v for k, v in inp.items() if k.startswith("moe/p/")}, device="cpu")
x = torch.tensor(inp["moe/x"])
dx = S.place(x, mesh22, S.batch_spec(mesh22, 2))
y = moe.moe_sam_dispatch(S.place(p, mesh22), dx, k=@K@, capacity_factor=1.0,
                         compute_dtype=torch.float32)
out["moe/y"] = y.full_tensor().numpy()
out["moe/group_size"] = np.asarray(S.data_group_size())
# the dense dispatch, the baseline, on placed parameters (gathered whole)
out["moe/dense"] = moe.moe_dense_dispatch(
    S.place(p, mesh22), dx, k=@K@, compute_dtype=torch.float32).full_tensor().numpy()

# a placed prefill and two decode steps against the plain ones on one
# device (the same MoE groups: the policy of a (2, 2) mesh)
def serve(arch, placed):
    cfg, params, _ = tree_of(arch)
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (@B@, 10)))
    caches = M.init_caches(cfg, @B@, 16, dtype=torch.float32, device="cpu")
    if placed:
        params = S.place(params, mesh22)
        caches = S.place(caches, mesh22, S.cache_shardings(mesh22, caches))
    logits = []
    for lo, hi in ((0, 8), (8, 9), (9, 10)):
        b = {"tokens": toks[:, lo:hi]}
        if placed:
            b = S.place(b, mesh22, S.batch_shardings(mesh22, b))
        lg, caches = M.forward(cfg, params, b, caches)
        logits.append(S.full_tensors(lg).numpy())
    return logits

for arch in @SERVED@:
    for i, lg in enumerate(serve(arch, True)):
        out[f"serve/{arch}/placed/{i}"] = lg
    if rank == 0:
        devs = np.empty(4, dtype=object)
        devs[:] = [torch.device("cpu")] * 4
        S.set_activation_policy(Mesh(devs.reshape(2, 2), ("data", "model")))
        for i, lg in enumerate(serve(arch, False)):
            out[f"serve/{arch}/plain/{i}"] = lg
        S.set_activation_policy(mesh22)

# checkpoints between meshes, and reshard
cfg, params, _ = tree_of("qwen3-0.6b")
opt = AdamWConfig(lr=1e-3, total_steps=3, warmup_steps=1)
step_fn = make_train_step(cfg, opt, remat="dots")
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import batch_for_step
shape = ShapeConfig("c", @S@, @B@, "train")

def runner_on(mesh, directory):
    def data_fn(step):
        b = batch_for_step(cfg, shape, step, device="cpu")
        return b if mesh is None else S.place(b, mesh, S.batch_shardings(mesh, b))
    def run(state, b):
        p_, o_, m = step_fn(*state, b)
        return (p_, o_), m
    return TrainingRunner(run, data_fn, Checkpointer(directory), ckpt_every=2)

def state_on(mesh):
    ps = params if mesh is None else S.place(params, mesh)
    return (ps, init_opt_state(opt, ps))

ckdir = sys.argv[3]
state22, golden = runner_on(mesh22, ckdir).run(state_on(mesh22), 3)
out["ckpt/golden"] = np.asarray([h["loss"] for h in golden])
ck = Checkpointer(ckdir)
assert ck.latest_step() == 2
written = S.full_tensors(ck.restore(state_on(mesh22), 2)[0])
for name, mesh in (("22", mesh22), ("41", mesh41)):
    S.set_activation_policy(mesh)
    restored, _ = ck.restore(state_on(mesh), 2)
    same = all(torch.equal(a, b) for a, b in zip(
        M.tree_leaves(S.full_tensors(restored)), M.tree_leaves(written)))
    _, hist = runner_on(mesh, ckdir).run(state_on(mesh), 3)
    out[f"ckpt/{name}/same"] = np.asarray(same)
    out[f"ckpt/{name}/resumed"] = np.asarray([h["loss"] for h in hist])
if rank == 0:          # one device, no mesh: plain tensors
    S.set_activation_policy(None)
    restored, _ = ck.restore(state_on(None), 2)
    same = all(torch.equal(a, b) for a, b in zip(
        M.tree_leaves(restored), M.tree_leaves(written)))
    _, hist = runner_on(None, ckdir).run(state_on(None), 3)
    out["ckpt/one/same"] = np.asarray(same)
    out["ckpt/one/resumed"] = np.asarray([h["loss"] for h in hist])
dist.barrier()
moved = elastic.reshard(state22, mesh41)
out["reshard/placements"] = np.asarray([
    a.placements == tuple(S.spec_placements(s, mesh41))
    for a, s in zip(M.tree_leaves(moved[0]),
                    M.tree_leaves(S.params_shardings(moved[0], mesh41)))]).all()
out["reshard/same"] = np.asarray(all(torch.equal(a, b) for a, b in zip(
    M.tree_leaves(S.full_tensors(moved)), M.tree_leaves(S.full_tensors(state22)))))
if rank == 0:
    np.savez(sys.argv[2], **out)
dist.destroy_process_group()
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **extra)
    env.pop("SAM_LANE_DEVICES", None)
    return env


def _torchrun(args, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=ROOT, **kw)


def _subst(script):
    """``script`` with its ``@NAME@`` constants filled in."""
    for name, v in (("ARCHS", ARCHS), ("WIDE", WIDE), ("SERVED", SERVED),
                    ("SSM", SSM),
                    ("WATCH", sorted({*SPLIT_SSM, *SPLIT_MLA})),
                    ("D_MODEL", MOE["d_model"]),
                    ("D_FF", MOE["d_ff"]), ("N_EXPERTS", MOE["n_experts"]),
                    ("K", MOE["k"]), ("S", S), ("B", B)):
        script = script.replace(f"@{name}@", repr(v))
    return textwrap.dedent(script)


def _one_device(inputs):
    """The port's one-device loss and gradients ({path: array}) of each
    architecture, with the policy of a (2, 2) mesh set (plain tensors)."""
    out = {}
    sharding.set_activation_policy(stand_in((2, 2)))
    try:
        for arch in ARCHS:
            cfg = dataclasses.replace(cfg_of(arch, get_config),
                                      compute_dtype="float32")
            params = params_from_numpy(ref_tree(arch), device="cpu")
            batch = {k: torch.tensor(inputs[f"{arch}/batch/{k}"])
                     for k in ("tokens", "labels")}
            loss, grads = value_and_grad(remat_loss_fn(cfg, "dots"), params,
                                         batch)
            out[f"{arch}/loss"] = loss.numpy()
            for k, g in leaves(grads).items():
                out[f"{arch}/grad{k}"] = g.numpy()
    finally:
        sharding.set_activation_policy(None)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placement")
    inputs = {}
    for arch in ARCHS:
        for k, v in leaves(ref_tree(arch)).items():
            inputs[f"{arch}/param{k}"] = v
        for k, v in make_batch(cfg_of(arch, ref_config), B, S).items():
            inputs[f"{arch}/batch/{k}"] = v
    inputs["moe/x"] = _moe_x()
    for k, v in ref_moe.init_moe(jax.random.PRNGKey(1), MOE["d_model"],
                                 MOE["d_ff"], MOE["n_experts"]).items():
        inputs[f"moe/p/{k}"] = np.asarray(v)
    np.savez(tmp / "in.npz", **inputs)
    ref = subprocess.Popen(
        [sys.executable, "-c", _subst(REF_SCRIPT), str(tmp / "in.npz"),
         str(tmp / "ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=_env(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    (tmp / "rank.py").write_text(_subst(RANK_SCRIPT))
    port = _torchrun([str(tmp / "rank.py"), str(tmp / "in.npz"),
                      str(tmp / "port.npz"), str(tmp / "ckpt")])
    cli_args = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                "--steps", "2"]
    cli = _torchrun(["-m", "repro_torch.launch.train", *cli_args,
                     "--model-parallel", "2", "--ckpt-dir",
                     str(tmp / "cli4")])
    try:
        one = _one_device(inputs)
        plain = train.main(cli_args + ["--ckpt-dir", str(tmp / "cli1")])
        logs = {name: p.communicate(timeout=TIMEOUT)[0]
                for name, p in (("ref", ref), ("port", port), ("cli", cli))}
    finally:
        sharding.set_activation_policy(None)
        for p in (ref, port, cli):
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in (("ref", ref), ("port", port), ("cli", cli)):
        assert p.returncode == 0, f"{name} failed:\n{logs[name][-6000:]}"
    return {"ref": dict(np.load(tmp / "ref.npz")),
            "port": dict(np.load(tmp / "port.npz", allow_pickle=True)),
            "one": one,
            "cli": logs["cli"], "plain": plain}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_one_device_and_the_reference(arch, runs):
    port, one, ref = runs["port"], runs["one"], runs["ref"]
    assert bool(port[f"{arch}/placed"])
    grads = {k: v for k, v in port.items() if k.startswith(f"{arch}/grad/")}
    assert grads.keys() == {k for k in one if k.startswith(f"{arch}/grad/")}
    assert grads.keys() == {k for k in ref if k.startswith(f"{arch}/grad/")}
    for want in (one, ref):
        assert rel(port[f"{arch}/loss"], want[f"{arch}/loss"]) <= F32_LOSS
        errs = {k: rel(grads[k], want[k]) for k in grads}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= F32_GRAD, (worst, errs[worst])


@pytest.mark.parametrize("arch", SSM)
def test_packed_weight_path_step_equals_one_device(arch, runs):
    """The SSM cases' step with every packed product by the weight path
    (``sharding.packed_path`` forced; the step above takes the activation
    path at these token counts): the loss within 1e-5 and every gradient
    leaf within 1e-4 of the port's one-device step."""
    port, one = runs["port"], runs["one"]
    key = f"weight-path/{arch}"
    assert rel(port[f"{key}/loss"], one[f"{arch}/loss"]) <= F32_LOSS
    grads = {k[len(key) + 6:]: v for k, v in port.items()
             if k.startswith(f"{key}/grad/")}
    want = {k[len(arch) + 6:]: v for k, v in one.items()
            if k.startswith(f"{arch}/grad/")}
    assert grads.keys() == want.keys()
    errs = {k: rel(grads[k], want[k]) for k in grads}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= F32_GRAD, (worst, errs[worst])


def test_split_layers_issue_the_tensor_parallel_collectives(runs):
    """qwen3-0.6b-tp on (2, 2): the products split over the model axis
    (module docstring)."""
    port, arch = runs["port"], "qwen3-0.6b-tp"
    cfg = cfg_of(arch, get_config)
    local = B // 2 * S                   # tokens on one data shard
    logits = local * cfg.vocab * 4       # the label pick's float32 rows
    act = local * cfg.d_model * 4        # a float32 (B, S, D) activation
    for key in ("fwd", "step"):
        gathers = [r for r in port[f"{arch}/{key}"]
                   if r[0] == "all-gather" and r[1] == "model"]
        assert [r[3] for r in gathers] == [logits], key
    fwd = [r for r in port[f"{arch}/fwd"]
           if r[0] == "all-reduce" and r[1] == "model"]
    # two a layer (attention's and the MLP's row-parallel sums) and the
    # vocab-parallel embedding's
    assert len(fwd) == 2 * cfg.n_layers + 1
    assert all(r[3] == act for r in fwd)
    shards = port[f"{arch}/shards"]
    assert {r[0] for r in shards} == set(SPLIT)
    for name, whole, part in shards:
        d = SPLIT[name]
        assert part[d] == whole[d] // 2 and part[1 - d] == whole[1 - d], (
            name, whole, part)


def _expert_bytes(cfg):
    """The float32 bytes of one layer's expert stack (E, D, F)."""
    return cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 4


@pytest.mark.parametrize("arch", EP)
def test_experts_stay_on_their_expert_parallel_shards(arch, runs):
    """The MoE block on (2, 2): each card keeps E/4 experts of each stack
    while the layer runs, no expert stack is gathered (nor its gradient
    reduce-scattered) on any axis, and the tokens move to the experts
    (all-to-all over the data axis, forth and back in the forward and in
    its recompute, and once more each way for the gradients)."""
    port, cfg = runs["port"], cfg_of(arch, get_config)
    experts = [r for r in port[f"{arch}/shards"] if r[0].startswith("moe/")
               and len(r[1]) == 3]
    assert {r[0] for r in experts} == {"moe/w_gate", "moe/w_up",
                                       "moe/w_down"}
    for name, whole, part in experts:
        assert whole[0] == cfg.n_experts and part == (
            cfg.n_experts // 4,) + whole[1:], (name, whole, part)
    full = _expert_bytes(cfg)
    for key in ("fwd", "step"):
        moved = [r for r in port[f"{arch}/{key}"] if r[0] in (
            "all-gather", "reduce-scatter") and r[3] in (full, full // 2)]
        assert not moved, (key, moved)
    a2a = [r for r in port[f"{arch}/step"] if r[0] == "all-to-all"]
    assert len(a2a) == 6 and {r[1] for r in a2a} == {"data"}, a2a


def test_mla_heads_split_over_the_model_axis(runs):
    """deepseek-v3-671b-tp on (2, 2): MLA's head projections keep half
    their model-axis dim on each card where its layer runs."""
    shards = [r for r in runs["port"]["deepseek-v3-671b-tp/shards"]
              if r[0] in SPLIT_MLA]
    assert {r[0] for r in shards} == set(SPLIT_MLA)
    for name, whole, part in shards:
        d = SPLIT_MLA[name]
        assert part[d] == whole[d] // 2 and part[1 - d] == whole[1 - d], (
            name, whole, part)


def _placed_serving_equals_the_plain(port, arch):
    for i in range(3):
        got = port[f"serve/{arch}/placed/{i}"]
        want = port[f"serve/{arch}/plain/{i}"]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert rel(got, want) <= F32_LOSS, (arch, i, rel(got, want))


def test_placed_mla_prefill_and_decode_equal_the_plain_ones(runs):
    _placed_serving_equals_the_plain(runs["port"], "deepseek-v3-671b-tp")


@pytest.mark.parametrize("arch", SSM)
def test_placed_ssm_prefill_and_decode_equal_the_plain_ones(arch, runs):
    """xlstm-125m-tp and zamba2-2.7b-tp on (2, 2): the mLSTM and mamba2
    states on their heads' shards, the conv windows, the sLSTM states and
    the shared block's KV cache carried through a prefill and two decode
    steps, each step's logits within 1e-5 of one device's."""
    _placed_serving_equals_the_plain(runs["port"], arch)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_heads_split_over_the_model_axis(arch, runs):
    """The SSM cases on (2, 2): mLSTM's ``w_up`` (packed ``[xi | gate]``),
    ``wq``/``wk``/``wv`` and ``w_down``, mamba2's ``out_proj`` and the
    shared block's projections keep half their model-axis dim on each card
    where their layer runs (the packed ``w_up`` then goes whole or not by
    ``sharding.packed_path``)."""
    shards = runs["port"][f"{arch}/shards"]
    assert {r[0] for r in shards} == SPLIT_SHOWN[arch]
    for name, whole, part in shards:
        d = SPLIT_SSM[name]
        assert part[d] == whole[d] // 2 and part[1 - d] == whole[1 - d], (
            name, whole, part)


@pytest.mark.parametrize("n_experts", [64, 256])
@pytest.mark.parametrize("sizes", [(16, 16), (2, 16, 16)], ids=str)
def test_dispatch_buffers_follow_the_rules_expert_axes(sizes, n_experts):
    """The placed dispatch's buffers split E over the mesh axes that the
    rules give the expert stacks (``sharding.expert_axes``), read from the
    stacks' placements: on (2, 16, 16) with E = 256 that is (model, data),
    where an own choice (model, then each batch axis that divides) would
    take (model, pod) and move the weights every layer. A pure mapping,
    no processes."""
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                       "model")
    mesh = stand_in(sizes, names)
    shape = (2, n_experts, 7168, 2048)
    spec = sharding.param_spec("layers/moe/w_gate", shape, mesh)
    want = sharding.expert_axes(spec)
    assert want == {64: ("model",), 256: ("model", "data")}[n_experts]
    local = sharding.spec_placements(spec[1:], mesh)     # a layer's stack
    # the groups (g, T/g, D), split over the data axes
    groups = sharding.spec_placements(sharding.batch_spec(mesh, 3), mesh)
    split, exchange, rest = moe._ep_layout(local, groups,
                                           [mesh.shape[a] for a in names])
    assert {names[i] for i in split} == set(want)
    assert [names[i] for i in exchange] == [a for a in names
                                            if a == "data" and a in want]
    assert [names[i] for i in rest] == ["model"]


def test_grouped_moe_dispatch_equals_the_reference(runs):
    port, ref = runs["port"], runs["ref"]
    assert int(port["moe/group_size"]) == int(ref["moe/group_size"]) == 2
    assert rel(port["moe/y"], ref["moe/y"]) <= MOE_TOL
    # and so does the port's grouped dispatch on plain tensors
    p = {k[6:]: v for k, v in ref.items() if k.startswith("moe/p/")}
    x = _moe_x()
    sharding.set_activation_policy(stand_in((2, 2)))
    try:
        y = moe.moe_sam_dispatch(
            params_from_numpy(p, device="cpu"), torch.tensor(x),
            k=MOE["k"], capacity_factor=1.0, compute_dtype=torch.float32)
    finally:
        sharding.set_activation_policy(None)
    assert rel(y, ref["moe/y"]) <= MOE_TOL
    # the dense dispatch on placed parameters equals its plain result
    assert rel(port["moe/dense"], np.asarray(moe.moe_dense_dispatch(
        params_from_numpy(p, device="cpu"), torch.tensor(x), k=MOE["k"],
        compute_dtype=torch.float32))) <= MOE_TOL
    # one group differs: the capacity is per (group, expert)
    one = ref_moe.moe_sam_dispatch(p, x, k=MOE["k"], capacity_factor=1.0,
                                   compute_dtype=np.float32)
    assert rel(np.asarray(one), ref["moe/y"]) > 1e-3


def _moe_x():
    return np.random.default_rng(7).normal(
        size=(int(np.prod(MOE["tokens"])), MOE["d_model"])).astype(np.float32)


@pytest.mark.parametrize("where", ["22", "41", "one"])
def test_checkpoint_moves_between_meshes(where, runs):
    port = runs["port"]
    golden = port["ckpt/golden"]
    assert golden.shape == (3,) and np.isfinite(golden).all()
    assert bool(port[f"ckpt/{where}/same"])
    resumed = port[f"ckpt/{where}/resumed"]
    assert resumed.shape == (1,)
    assert resumed[0] == golden[2]


def test_reshard_keeps_every_full_tensor(runs):
    assert bool(runs["port"]["reshard/placements"])
    assert bool(runs["port"]["reshard/same"])


def test_train_cli_under_torchrun(runs):
    lines = [ln for ln in runs["cli"].splitlines()
             if ln.startswith("[train] losses ")]
    assert len(lines) == 1, runs["cli"][-3000:]
    assert "[train] qwen3-0.6b steps=2 loss " in runs["cli"]
    assert "on a {'data': 2, 'model': 2} mesh" in runs["cli"]
    got = json.loads(lines[0][len("[train] losses "):])
    want = runs["plain"]
    assert len(got) == len(want) == 2
    assert abs(got[0] - want[0]) <= F32_LOSS
    assert abs(got[1] - want[1]) <= 1e-4
