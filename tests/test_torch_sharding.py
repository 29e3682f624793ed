"""The logical-axis rules (``repro_torch.distributed.sharding``) against the
reference's (``repro.distributed.sharding``), the training mesh
(``launch.mesh``), ``opt_state_axes``, ``remesh``, and the training driver
on a data-parallel mesh of two processes set up through torchrun's
variables.

The reference's specs are read on ``jax.sharding.AbstractMesh`` meshes of
the same shapes (an abstract mesh cannot be entered, so the reference's
context is set directly); the port's on ``launch.mesh.Mesh`` objects of
those shapes over the host, which may repeat a device.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import colbertv2 as rcfgs  # noqa: E402
from repro.distributed import sharding as rshard  # noqa: E402
from repro.models import colbert as rcol  # noqa: E402
from repro.models import transformer as rT  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch.configs import colbertv2 as tcfgs  # noqa: E402
from repro_torch.distributed import sharding as tshard  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.training import fault_tolerance as tft  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {  # name -> the reference's (shape, axis names)
    "local": ((1, 1), ("data", "model")),
    "data4": ((4, 1), ("data", "model")),
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
    "pods": ((2, 4, 1), ("pod", "data", "model")),
}
RULES = {"default": None, "serve": rshard.SERVE_RULES, "zero3": rshard.ZERO3_RULES}
#: activation axes the reference's models constrain, with shapes that
#: divide some extents and not others (kv_heads 1: MQA under a 16-way axis)
ACTIVATIONS = [
    (("batch", "seq", "embed"), (32, 180, 768)),
    (("batch", "seq", "heads", "head_dim"), (32, 180, 48, 64)),
    (("batch", "seq", "kv_heads", "head_dim"), (8, 180, 1, 64)),
    (("batch", "seq", None), (6, 32, 128)),
    (("batch", "seq", "vocab"), (32, 64, 30528)),
    (("batch", "experts", None, None), (32, 8, 4, 768)),
    (("batch", "cache_seq", "kv_heads", "head_dim"), (4, 1024, 8, 128)),
    (("batch", "act_seq", "embed"), (4, 1024, 768)),
    ((None, "batch", None, None), (2, 16, 8, 16)),
    (("docs", "centroids"), (1 << 20, 1 << 16)),
]


def _port_mesh(name):
    shape, axes = MESHES[name]
    n = int(np.prod(shape))
    return tmesh.Mesh(("cpu",) * n, axes=tuple(zip(axes, shape)))


def _ref_spec(name, rules, axes, shape):
    ctx = rshard._CTX
    prev = (ctx.mesh, ctx.rules)
    ctx.mesh = AbstractMesh(*MESHES[name])
    ctx.rules = dict(rshard.DEFAULT_RULES, **(rules or {}))
    try:
        return tuple(rshard.logical_to_spec(axes, shape=shape))
    finally:
        ctx.mesh, ctx.rules = prev


def _norm(spec):
    """A spec with one-axis tuples written as the bare name (jax may keep
    either spelling)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


def test_rule_tables_equal_the_reference():
    assert tshard.DEFAULT_RULES == rshard.DEFAULT_RULES
    assert tshard.SERVE_RULES == rshard.SERVE_RULES
    assert tshard.ZERO3_RULES == rshard.ZERO3_RULES
    assert tshard.active_rules() == rshard.active_rules()
    with tshard.use_mesh(None, tshard.ZERO3_RULES):
        assert tshard.active_rules() == dict(rshard.DEFAULT_RULES, **rshard.ZERO3_RULES)
    assert tshard.active_mesh() is None


def _model_axes():
    """(logical axes, shape) of every parameter of the reference's models:
    ColBERTv2 at full width, and an LM with MoE layers (expert axes)."""
    cfg = rcfgs.full_config()
    out = []
    shapes = jax.eval_shape(lambda: rcol.init_params(jax.random.PRNGKey(0), cfg))
    leaves = jax.tree_util.tree_leaves(rcol.param_axes(cfg), is_leaf=lambda t: isinstance(t, tuple))
    out += zip(leaves, [s.shape for s in jax.tree_util.tree_leaves(shapes)])
    lm = rT.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=250,
                              n_experts=4, first_dense=1, n_shared=1)
    shapes = jax.eval_shape(lambda: rT.init_params(jax.random.PRNGKey(0), lm))
    leaves = jax.tree_util.tree_leaves(rT.param_axes(lm), is_leaf=lambda t: isinstance(t, tuple))
    out += zip(leaves, [s.shape for s in jax.tree_util.tree_leaves(shapes)])
    return out


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_to_spec_matches_reference(mesh, rules):
    cases = _model_axes() + ACTIVATIONS
    with tshard.use_mesh(_port_mesh(mesh), RULES[rules]):
        for axes, shape in cases:
            want = _norm(_ref_spec(mesh, RULES[rules], axes, shape))
            assert _norm(tshard.logical_to_spec(axes, shape=shape)) == want, (axes, shape)
            assert _norm(tshard.logical_to_spec(axes)) == _norm(
                _ref_spec(mesh, RULES[rules], axes, None)), axes
    with tshard.use_mesh(None):  # no mesh: the raw rules pass through
        assert tshard.logical_to_spec((None, "mlp", "batch")) == (None, "model", ("pod", "data"))


def test_port_param_axes_are_the_reference_per_layer():
    """The port's ``param_axes`` is the reference's in the training tree's
    layout: each layer stack a list of per-layer tuples without the
    leading "layers" axis, and no ``lm_head``."""
    rcfg, tcfg = rcfgs.full_config(), tcfgs.full_config()
    want = rcol.param_axes(rcfg)
    del want["backbone"]["lm_head"]
    got = tcol.param_axes(tcfg)
    model = tcol.ColBERT(tcfg, tcol.T.Transformer(tcfg.backbone, "meta"))
    params = tcol.train_params(model)
    assert len(ttree.leaves(got)) == len(ttree.leaves(params))  # one tuple a tensor
    for (path, w) in jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda t: isinstance(t, tuple)):
        node, pnode = got, params
        for k in path:
            node, pnode = node[k.key], pnode[k.key]
        if w and w[0] == "layers":
            assert node == [w[1:]] * tcfg.backbone.n_layers, path
            assert all(len(t.shape) == len(w) - 1 for t in pnode), path
        else:
            assert node == w and len(pnode.shape) == len(w), path
    assert topt.opt_state_axes(got) == {"mu": got, "nu": got, "step": ()}
    assert ropt.opt_state_axes(want) == {"mu": want, "nu": want, "step": ()}


def test_constrain_is_the_identity_on_a_data_mesh_and_model_axes_raise():
    x = torch.arange(12.0).reshape(4, 3)
    axes = tcol.param_axes(tcfgs.reduced_config())
    with tshard.use_mesh(_port_mesh("data4")):
        assert tshard.constrain(x, "batch", None) is x
        assert tshard.constrain_tree({"a": x}, {"a": ("batch", None)})["a"] is x
        shard = tshard.tree_shardings(axes)
        assert set(ttree.leaves(shard)) == {torch.device("cpu")}
        with pytest.raises(NotImplementedError, match="one device a process"):
            tshard.data_mesh()  # training runs one replica a process
    assert tshard.constrain(x, "batch") is x  # no mesh
    for name in ("single", "multi"):
        with tshard.use_mesh(_port_mesh(name)):
            for call in (lambda: tshard.constrain(x, "batch", None),
                         lambda: tshard.tree_shardings(axes), tshard.data_mesh):
                with pytest.raises(NotImplementedError, match=r"Queue 1 item 8\.5\.6"):
                    call()


def test_mesh_axes_and_the_training_meshes():
    m = tmesh.make_local_mesh("cpu")
    assert m.shape == {"data": 1, "model": 1} and m.axis_names == ("data", "model")
    assert tmesh.Mesh(("cpu",) * 3).shape == {"data": 3}  # a document-sharding mesh
    with pytest.raises(ValueError, match="multiply"):
        tmesh.Mesh(("cpu",) * 4, axes=(("data", 2), ("model", 1)))
    one = tmesh.make_production_mesh(device="cpu")  # one process: a 1 x 1 mesh
    assert one.shape == {"data": 1, "model": 1} and one.devices == (torch.device("cpu"),)
    assert tmesh.make_production_mesh(multi_pod=True, device="cpu").shape == {
        "pod": 1, "data": 1, "model": 1}


def test_remesh_places_a_host_state_bit_for_bit():
    rng = np.random.default_rng(0)
    host = {"params": {"w": [rng.standard_normal((3, 2)).astype(np.float32) for _ in range(2)],
                       "b": rng.standard_normal(4).astype(np.float32)},
            "opt": {"step": np.asarray(3, np.int32)}}
    for shardings in (torch.device("cpu"), ttree.tree_map(lambda _: torch.device("cpu"), host)):
        got = tft.remesh(host, shardings)
        for g, h in zip(ttree.leaves(got), ttree.leaves(host)):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), h)
            assert g.dtype == torch.from_numpy(h).dtype


def test_train_step_on_a_model_axis_raises():
    model = tcol.init_params(tcfgs.reduced_config(), torch.Generator().manual_seed(0), device="cpu")
    opt = topt.adamw(topt.AdamWConfig())
    params = tcol.train_params(model)
    step = tloop.make_train_step(tcol.loss_fn(model), opt,
                                 param_axes=tcol.param_axes(model.cfg))
    with tshard.use_mesh(_port_mesh("single")):
        with pytest.raises(NotImplementedError, match=r"Queue 1 item 8\.5\.6"):
            step(params, tloop.init_opt_state(opt, params), {})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_train_mesh_single_over_two_torchrun_ranks(tmp_path):
    """Two processes with torchrun's variables: rank 0 alone prints and
    writes checkpoints, the loss is the one-process run's (the same global
    batches), and the replicas end bit-identical (the driver checks)."""
    args = ["--arch", "plaid-colbertv2", "--reduced", "--steps", "3", "--device", "cpu",
            "--ckpt-every", "2"]
    base = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--mesh", "single",
         "--ckpt-dir", str(tmp_path / "dp")],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args,
                          "--ckpt-dir", str(tmp_path / "one")],
                         env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=240)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert one.returncode == 0, one.stderr[-2000:]
    lead = outs[0][0].strip().splitlines()
    assert lead[0].endswith("steps=3 mesh={'data': 2, 'model': 1}"), lead
    assert outs[1][0].strip() == ""  # rank 1 prints nothing
    assert lead[1].startswith("done: 3 steps") and "restarts=0" in lead[1]
    # the same global batches: the loss line agrees to its printed digits
    assert lead[2] == one.stdout.strip().splitlines()[2]
    assert sorted(os.listdir(tmp_path / "dp")) == ["step_00000002", "step_00000003"]
