"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding``), element for element, on the production
meshes: the port's are ``DeviceMesh``es over a fake process group of 256
or 512 ranks, the reference's the ``FakeMesh`` classes of
``tests/test_sharding_roofline.py``.  Also ``tree_map_with_path_names``,
``ArchConfig.input_specs``, the production and host meshes, the
activation constraints, and the MoE's grouped dispatch under a policy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import api as ref_api
from repro.sharding import specs as ref_sh
from repro.utils import tree as ref_tree
from repro_torch.configs import base
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api
from repro_torch.sharding import act
from repro_torch.sharding import specs as sh
from repro_torch.utils.tree import tree_map_with_path_names


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakeMeshMP:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": (FakeMesh, False), "2x16x16": (FakeMeshMP, True)}
ARCHS = base.arch_names()


@pytest.fixture(params=list(MESHES))
def meshes(request):
    """(reference FakeMesh, the port's DeviceMesh over a fake world)."""
    ref_cls, multi = MESHES[request.param]
    with mesh_lib.fake_world(512 if multi else 256):
        yield ref_cls(), mesh_lib.make_production_mesh(multi_pod=multi,
                                                       device_type="cpu")


def _names(fn, tree, path_fn):
    out = {}
    path_fn(lambda n, l: out.__setitem__(n, fn(n, l)), tree)
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_base.get_arch(arch)
    return jax.eval_shape(lambda: ref_api.init_params(
        cfg, jax.random.PRNGKey(0)))


def _same(port: dict, ref: dict):
    assert set(port) == set(ref)
    for name in ref:
        assert tuple(port[name]) == tuple(ref[name]), name


# ---------------------------------------------------------------------------
# tree names, input specs, meshes
# ---------------------------------------------------------------------------

def test_tree_map_with_path_names_matches_reference():
    tree = {"b": [np.zeros(1), (np.zeros(2), None, np.zeros(3))],
            "a": {"z": np.zeros(4), "y": [np.zeros(5)]}}
    ref = _names(lambda n, l: l.shape, tree, ref_tree.tree_map_with_path_names)
    port = _names(lambda n, l: l.shape, tree, tree_map_with_path_names)
    assert port == ref
    assert list(port) == ["a/y/0", "a/z", "b/0", "b/1/0", "b/1/2"]


@pytest.mark.parametrize("shape", list(base.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    ref = ref_base.get_arch(arch).input_specs(ref_base.SHAPES[shape])
    port = base.get_arch(arch).input_specs(base.SHAPES[shape])
    assert set(port) == set(ref)
    for k, v in ref.items():
        assert tuple(port[k].shape) == tuple(v.shape), k
        assert port[k].device.type == "meta"
        assert str(port[k].dtype).split(".")[-1] == str(v.dtype)


def test_input_specs_under_fake_mode():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    with FakeTensorMode():
        specs = base.get_arch("seamless-m4t-medium").input_specs(
            base.SHAPES["train_4k"], device="cpu")
    assert all(isinstance(t, FakeTensor) for t in specs.values())
    assert specs["frontend"].dtype == torch.bfloat16


def test_production_meshes_and_fake_world():
    import torch.distributed as dist

    with mesh_lib.fake_world(256):
        m = mesh_lib.make_production_mesh(device_type="cpu")
        assert act.mesh_axes(m) == {"data": 16, "model": 16}
        with pytest.raises(RuntimeError):
            mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")
    assert not dist.is_initialized()
    with mesh_lib.fake_world(512):
        m = mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")
        assert act.mesh_axes(m) == {"pod": 2, "data": 16, "model": 16}
    assert not dist.is_initialized()


def test_host_mesh_on_the_cpu():
    import torch.distributed as dist

    try:
        m = mesh_lib.make_host_mesh(device_type="cpu")
        assert act.mesh_axes(m) == {"data": 1, "model": 1}
        with pytest.raises(ValueError):
            mesh_lib.make_host_mesh(model_parallel=2, device_type="cpu")
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mesh_lib.make_host_mesh()


# ---------------------------------------------------------------------------
# the rules, element for element
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, meshes):
    ref_mesh, mesh = meshes
    cfg, ref_cfg = base.get_arch(arch), ref_base.get_arch(arch)
    ref_rep, rep = ref_sh.ShardingReport(), sh.ShardingReport()
    ref = _names(lambda n, l: ref_sh.param_pspec(n, l, ref_mesh, ref_cfg,
                                                 ref_rep),
                 _ref_params(arch), ref_tree.tree_map_with_path_names)
    params = api.init_params(cfg, device="meta")
    port = _names(lambda n, l: sh.param_pspec(n, l, mesh, cfg, rep),
                  params, tree_map_with_path_names)
    _same(port, ref)
    assert rep.degraded == ref_rep.degraded
    # the shardings' placements on the mesh follow the specs
    shardings = sh.params_shardings(params, mesh, cfg)
    names = list(act.mesh_axes(mesh))
    for n, s in _names(lambda n, s: s, shardings,
                       tree_map_with_path_names).items():
        for md, pl in enumerate(s.placements):
            dims = [d for d, ax in enumerate(port[n]) if ax is not None
                    and names[md] in ((ax,) if isinstance(ax, str) else ax)]
            assert (pl.is_shard(dims[0]) if dims else pl.is_replicate()), n


@pytest.mark.parametrize("shape", list(base.SHAPES))
def test_batch_pspecs_match_reference(shape, meshes):
    ref_mesh, mesh = meshes
    for arch in ("qwen3-0.6b", "phi-3-vision-4.2b", "seamless-m4t-medium"):
        specs = ref_base.get_arch(arch).input_specs(ref_base.SHAPES[shape])
        for micro in (False, True):
            for profile in ("megatron", "dp_only"):
                for name, leaf in specs.items():
                    lead = (4,) if micro else ()
                    shp = (*lead, *leaf.shape)
                    ref_rep, rep = ref_sh.ShardingReport(), \
                        sh.ShardingReport()
                    want = ref_sh.batch_pspec(
                        name, jax.ShapeDtypeStruct(shp, leaf.dtype),
                        ref_mesh, ref_rep, micro, profile)
                    got = sh.batch_pspec(
                        name, torch.empty(shp, device="meta"), mesh, rep,
                        micro, profile)
                    assert tuple(got) == tuple(want), (arch, name, micro,
                                                       profile)
                    assert rep.degraded == ref_rep.degraded
    assert sh.dp_total(mesh, "dp_only") == ref_sh.dp_total(ref_mesh,
                                                           "dp_only")
    assert sh.dp_total(mesh) == ref_sh.dp_total(ref_mesh)


def _kv_rep(cfg, mesh_shape):
    tp = mesh_shape["model"]
    return (min(tp // cfg.n_kv_heads, 4)
            if cfg.family != "encdec" and tp > cfg.n_kv_heads else 1)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_pspecs_match_reference(arch, shape, meshes):
    ref_mesh, mesh = meshes
    ref_cfg, cfg = ref_base.get_arch(arch), base.get_arch(arch)
    if not cfg.supports(base.SHAPES[shape]):
        return
    b, s = base.SHAPES[shape].global_batch, base.SHAPES[shape].seq_len
    kv = _kv_rep(cfg, ref_mesh.shape)
    ref_state = jax.eval_shape(lambda: ref_api.init_decode_state(
        ref_cfg, b, s, kv_replication=kv))
    state = api.init_decode_state(cfg, b, s, kv_replication=kv,
                                  device="meta")
    ref_rep, rep = ref_sh.ShardingReport(), sh.ShardingReport()
    ref = _names(lambda n, l: ref_sh.decode_state_pspec(n, l, ref_mesh,
                                                        ref_cfg, ref_rep),
                 ref_state, ref_tree.tree_map_with_path_names)
    port = _names(lambda n, l: sh.decode_state_pspec(n, l, mesh, cfg, rep),
                  state, tree_map_with_path_names)
    _same(port, ref)
    assert rep.degraded == ref_rep.degraded


def test_logits_and_scalar_shardings_match_reference(meshes, monkeypatch):
    ref_mesh, mesh = meshes
    monkeypatch.setattr(ref_sh, "NamedSharding", lambda m, spec: spec)
    for gb in (None, 128, 1, 4):
        assert tuple(sh.logits_sharding(mesh, gb).spec) == \
            tuple(ref_sh.logits_sharding(ref_mesh, gb))
    assert tuple(sh.scalar_sharding(mesh).spec) == \
        tuple(ref_sh.scalar_sharding(ref_mesh))


def test_degradation_on_indivisible_matches_reference():
    class Odd:
        axis_names = ("data", "model")
        shape = {"data": 16, "model": 16}

    ref_rep, rep = ref_sh.ShardingReport(), sh.ShardingReport()
    for name, shp in (("blocks/0/attn/wq", (3, 100, 300)),
                      ("embed", (1000, 64)), ("blocks/0/mlp/wo", (5, 17))):
        want = ref_sh.param_pspec(name, jax.ShapeDtypeStruct(
            shp, jnp.bfloat16), Odd(), None, ref_rep)
        got = sh.param_pspec(name, torch.empty(shp, dtype=torch.bfloat16,
                                               device="meta"), Odd(), None,
                             rep)
        assert tuple(got) == tuple(want)
    assert rep.degraded == ref_rep.degraded and rep.degraded


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

def test_constrain_without_policy_or_on_plain_tensors():
    x = torch.randn(4, 8)
    act.clear_policy()
    assert act.constrain(x, "dp", None) is x
    assert act.axis_size("dp") is None
    act.set_policy(FakeMesh(), "data", "model")
    try:
        assert act.axis_size("dp") == 16 and act.axis_size("tp") == 16
        assert act.constrain(x, "dp", "tp") is x
        # the reference's divisibility fallback
        assert act.logical_spec((32, 8, 16), "dp", "tp", "tp") == \
            ("data", None, "model")
    finally:
        act.clear_policy()


def test_constrain_redistributes_dtensors():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with mesh_lib.fake_world(4):
        mesh = mesh_lib.make_mesh("cpu", (2, 2), ("data", "model"))
        x = distribute_tensor(torch.zeros(8, 6), mesh,
                              [Replicate(), Replicate()])
        act.set_policy(mesh, "data", "model")
        try:
            y = act.constrain(x, "dp", "tp")
            assert tuple(y.placements) == (Shard(0), Shard(1))
            assert tuple(y.to_local().shape) == (4, 3)
            # 6 % 2 == 0 but a dim below the axis size stays whole
            z = act.constrain(distribute_tensor(
                torch.zeros(8, 1), mesh, [Replicate(), Replicate()]),
                "dp", "tp")
            assert tuple(z.placements) == (Shard(0), Replicate())
        finally:
            act.clear_policy()


# ---------------------------------------------------------------------------
# the MoE under a policy
# ---------------------------------------------------------------------------

def test_moe_takes_grouped_at_the_dp_size(monkeypatch):
    """With a policy of dp = 4 the port's ``auto`` picks the grouped
    dispatch at 4 groups and matches the reference's grouped dispatch
    under the same policy (its constraints made the identity)."""
    from repro.models import moe as ref_moe
    from repro.sharding import act as ref_act
    from repro_torch.models import moe

    class Dp4:
        axis_names = ("data", "model")
        shape = {"data": 4, "model": 1}

    rng = np.random.default_rng(0)
    d, f, e, b, s = 16, 8, 8, 4, 8
    p = {"router": rng.standard_normal((d, e)).astype(np.float32),
         "wi_gate": rng.standard_normal((e, d, f)).astype(np.float32) / 4,
         "wi_up": rng.standard_normal((e, d, f)).astype(np.float32) / 4,
         "wo": rng.standard_normal((e, f, d)).astype(np.float32) / 4}
    x = rng.standard_normal((b, s, d)).astype(np.float32)

    seen = {}
    real = moe.dispatch_grouped

    def spy(*a, **kw):
        seen["groups"] = kw.get("groups")
        return real(*a, **kw)

    monkeypatch.setattr(moe, "dispatch_grouped", spy)
    monkeypatch.setattr(ref_act, "constrain", lambda x, *a: x)
    monkeypatch.setattr(ref_act, "_POLICY",
                        {"mesh": Dp4(), "dp": "data", "tp": "model"})
    act.set_policy(Dp4(), "data", "model")
    try:
        pt = {k: torch.from_numpy(v).to(torch.bfloat16
                                        if k != "router" else torch.float32)
              for k, v in p.items()}
        out, aux = moe.apply_moe(pt, torch.from_numpy(x).to(torch.bfloat16),
                                 top_k=2)
    finally:
        act.clear_policy()
    assert seen["groups"] == 4
    pj = {k: jnp.asarray(v, jnp.bfloat16 if k != "router" else jnp.float32)
          for k, v in p.items()}
    want, want_aux = ref_moe.apply_moe(pj, jnp.asarray(x, jnp.bfloat16),
                                       top_k=2)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    # no policy: dropping, as before
    seen.clear()
    moe.apply_moe(pt, torch.from_numpy(x).to(torch.bfloat16), top_k=2)
    assert "groups" not in seen
