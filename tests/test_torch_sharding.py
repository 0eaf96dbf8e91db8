"""The port's sharding rules against the reference's, without processes.

For each of the 10 registry architectures, at the SMOKE and the full
configuration (full through ``launch.specs`` on the meta device and the
reference's ``jax.eval_shape``; nothing allocated), on ``{data: 2,
model: 2}``, ``{data: 4, model: 2}``, ``(16, 16)`` and ``(2, 16, 16)``, with
``fsdp`` off and on: the port's spec of each parameter equals the
reference's spec of the matching stacked leaf with its stack dims
dropped; batch and cache specs equal the reference's; the optimizer
state specs (float32 and int8 moments) equal it except where the
reference's ZeRO-1 rule puts ``data`` on a stack dim, which the port's
per-block leaf has not got (pinned below). The rules read only axis
sizes, so meshes are ``{axis: size}`` mappings here. The last tests hold
DTensor's layout of a dim split over several axes to the reference's
``NamedSharding`` blocks on forced CPU devices.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro.configs import registry as rregistry
from repro.launch import specs as rspecs
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro.sharding import rules as rrules
from repro.train import loop as rloop
from repro_torch.configs import registry
from repro_torch.launch import specs
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train import loop as tl

MESHES = {"2x2": {"data": 2, "model": 2}, "4x2": {"data": 4, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
SIZES = ("smoke", "full")
CASES = [(a, s) for a in registry.ARCH_IDS for s in SIZES]


class _Mesh:
    """What the reference's rules read of a mesh: ``shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _norm(spec, ndim):
    """A spec as a tuple of ndim entries; a one-axis tuple as its axis
    (the reference's PartitionSpec spells ("data",) as "data")."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in tuple(spec)]
    return tuple(out + [None] * (ndim - len(out)))


def _cfgs(arch, size):
    if size == "smoke":
        return rregistry.smoke_config(arch), registry.smoke_config(arch)
    return rregistry.config(arch), registry.config(arch)


@functools.lru_cache(maxsize=None)
def _models(arch, size):
    """(reference param SDS tree, port meta model, port params)."""
    rcfg, pcfg = _cfgs(arch, size)
    rp = rspecs.params_specs(rlm.build(rcfg))
    model = specs.build(pcfg)
    return rp, model, specs.params_specs(model)


def _ref_keys(model, name):
    """The reference pytree keys of port parameter ``name``: a block's
    leaves under their segment's name, a group's inner ModuleList index
    dropped (the reference stacks it)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tuple(parts)
    i = int(parts[1])
    for seg, idx in model.segment_blocks():
        if i in idx:
            return (seg.name,) + tuple(p for p in parts[2:]
                                       if not p.isdigit())
    raise KeyError(name)


def _lookup(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _path(keys):
    return tuple(jax.tree_util.DictKey(k) for k in keys)


def _drop(spec, lead):
    return spec[len(lead):]


@pytest.mark.parametrize("arch,size", CASES)
def test_param_specs_match_reference(arch, size):
    rp, model, params = _models(arch, size)
    stacks = model.stack_dims()
    for mname, shape in MESHES.items():
        rmesh = _Mesh(shape)
        for fsdp in (False, True):
            for name, p in params.items():
                keys = _ref_keys(model, name)
                leaf = _lookup(rp, keys)
                lead = stacks[name]
                assert tuple(leaf.shape) == lead + tuple(p.shape), name
                want = _norm(rrules.param_spec(_path(keys), leaf, rmesh,
                                               fsdp=fsdp), leaf.ndim)
                got = _norm(rules.param_spec(name, tuple(p.shape), shape,
                                             fsdp=fsdp, lead=lead), p.dim())
                if any(e is not None for e in want[:len(lead)]):
                    # a shared expert's stacked (n_blocks, D, F) leaf read
                    # as (E, D, F): E's shard lands on the stack dim
                    assert "shared" in keys and got == (None,) * p.dim(), \
                        (name, mname, want, got)
                    continue
                assert got == _drop(want, lead), (name, mname, fsdp, want,
                                                  got)


def _state_leaves(state):
    """{(moment, name, part): tensor} of a port OptState (part None, "q"
    or "scale")."""
    out = {}
    for mom in ("m", "v"):
        for n, t in getattr(state, mom).items():
            if isinstance(t, adamw.QTensor):
                out[(mom, n, "q")] = t.q
                out[(mom, n, "scale")] = t.scale
            else:
                out[(mom, n, None)] = t
    return out


def _ref_state_specs(rstate, rmesh, ocfg, fsdp):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            rstate, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)
    )[0]:
        keys = tuple(p.key for p in path
                     if isinstance(p, jax.tree_util.DictKey))
        attrs = [p.name for p in path
                 if isinstance(p, jax.tree_util.GetAttrKey)]
        if not keys:
            continue
        flat[(attrs[0],) + keys] = (leaf, rloop._state_spec_for(
            path, leaf, rmesh, ocfg, fsdp))
    return flat


def stack_dim_differences(arch, size, quantized):
    """Every (mesh, fsdp, moment, name, part) where the port's ZeRO-1
    state spec differs from the reference's with the stack dims dropped;
    each must be a leaf whose reference spec puts ``data`` on a stack dim,
    or an int8 moment of a scalar gate, which the reference quantizes
    over its stack dim. Returns them."""
    rp, model, params = _models(arch, size)
    stacks = model.stack_dims()
    rcfg = radamw.AdamWConfig(quantized_state=quantized)
    pcfg = adamw.AdamWConfig(quantized_state=quantized)
    rstate = rspecs.opt_state_specs(rcfg, rp)
    pstate = specs.opt_state_specs(pcfg, params)
    diffs = []
    for mname, shape in MESHES.items():
        rmesh = _Mesh(shape)
        for fsdp in (False, True):
            want_all = _ref_state_specs(rstate, rmesh, rcfg, fsdp)
            got_all = tl.state_shardings(pcfg, params, shape, fsdp=fsdp,
                                         stacks=stacks)
            assert got_all.step is None
            got_leaves = _state_leaves(got_all)
            for (mom, name, part), t in _state_leaves(pstate).items():
                keys = (mom,) + _ref_keys(model, name) + (
                    (part,) if part else ())
                rleaf, rspec = want_all[keys]
                lead = stacks[name]
                want = _norm(rspec, rleaf.ndim)
                got = _norm(got_leaves[(mom, name, part)].spec, t.dim())
                if tuple(rleaf.shape) != lead + tuple(t.shape):
                    # a stacked (n_groups,) gate is quantized along its
                    # stack dim; the port's scalar gate alone
                    assert part and params[name].dim() == 0, keys
                    diffs.append((mname, fsdp, mom, name, part, want, got))
                    continue
                if got == _drop(want, lead):
                    continue
                assert "data" in want[:len(lead)], (keys, mname, fsdp,
                                                     want, got)
                diffs.append((mname, fsdp, mom, name, part, want, got))
    return diffs


@pytest.mark.parametrize("arch,size", CASES)
def test_state_specs_match_reference_off_the_stack_dims(arch, size):
    """float32 and int8 moments: equal to the reference's ZeRO-1 state
    specs, or (only) where the reference shards a stack dim over data."""
    for quantized in (False, True):
        stack_dim_differences(arch, size, quantized)


def test_zero1_stack_dim_leaves_pinned():
    """The leaves whose ZeRO-1 layout differs from the reference's
    stacked leaf, named: mixtral-8x7b's (32, 8) ``router_bias`` moments
    at data 2 and 4 (the reference shards the 32 layers over data, the
    port's (8,) leaf its 8 experts), and
    llama-3.2-vision-90b's scalar gates' int8 moments (the reference
    quantizes the (n_groups,) stack of gates as one leaf, the port each
    gate alone)."""
    d = stack_dim_differences("mixtral_8x7b", "full", False)
    names = {(m, n.rsplit(".", 1)[-1]) for m, _, _, n, _, _, _ in d}
    assert names == {("2x2", "router_bias"), ("4x2", "router_bias")}
    for m, _, _, n, _, want, got in d:
        # the reference takes the larger dim, the 32 layers; the port's
        # leaf has only the 8 experts (at data 16 neither splits them)
        assert want == ("data", None) and got == ("data",)
    d = stack_dim_differences("llama32_vision_90b", "full", True)
    leaves = {(n.rsplit(".", 1)[-1], part) for _, _, _, n, part, _, _ in d}
    assert ("x_gate", "scale") in leaves and ("xffn_gate", "scale") in leaves


@pytest.mark.parametrize("arch,size", CASES)
def test_cache_and_batch_specs_match_reference(arch, size):
    rcfg, pcfg = _cfgs(arch, size)
    rmodel = rlm.build(rcfg)
    model = _models(arch, size)[1]
    for b in (32, 6, 1):
        rcache = rspecs.cache_specs(rmodel, b, 64)
        pcache = specs.cache_specs(model, b, 64)
        for mname, shape in MESHES.items():
            rmesh = _Mesh(shape)
            got = rules.cache_shardings(pcache, shape)
            rflat = jax.tree_util.tree_flatten_with_path(rcache)[0]
            assert len(rflat) > 0
            for path, leaf in rflat:
                keys = tuple(p.key for p in path)
                want = _norm(rrules.cache_spec(path, leaf, rmesh), leaf.ndim)
                pl = _lookup(pcache, keys)
                assert tuple(np.shape(pl)) == tuple(leaf.shape), keys
                assert _norm(_lookup(got, keys).spec, leaf.ndim) == want, \
                    (keys, mname, b)
    for shape_name in rregistry.shapes_for(arch):
        rc = rspecs.cell(arch, shape_name)
        pc = specs.cell(arch, shape_name)
        assert (rc.seq_len, rc.global_batch, rc.kind) == (
            pc.seq_len, pc.global_batch, pc.kind)
        rin = rspecs.model_inputs(rcfg, rc)
        pin = specs.model_inputs(pcfg, pc)
        assert rin.keys() == pin.keys()
        for mname, shape in MESHES.items():
            got = rules.batch_shardings(pin, shape)
            for k, v in rin.items():
                assert tuple(pin[k].shape) == tuple(v.shape)
                assert _norm(got[k].spec, v.ndim) == _norm(
                    rrules.batch_spec(_Mesh(shape), v.shape), v.ndim), \
                    (k, mname)


def test_rules_take_a_mesh_or_sizes_and_place():
    """Axis sizes from a mapping; ``placements`` in mesh order, a dim
    over several axes a Shard on each, out-of-order axes refused."""
    class FakeMesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    mesh = FakeMesh()
    assert rules.sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
    assert rules.placements(rules.Spec(("pod", "data"), None, "model"),
                            mesh) == (Shard(0), Shard(0), Shard(2))
    assert rules.placements(rules.Spec(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        rules.placements(rules.Spec(("model", "data")), mesh)
    with pytest.raises(ValueError, match="two dims"):
        rules.placements(rules.Spec("data", "data"), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        rules.placements(rules.Spec("expert"), mesh)


_BLOCKS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    out = []
    for shape, axes, spec, gshape in json.loads(sys.argv[1]):
        n = int(np.prod(shape))
        devs = np.array(jax.devices()[:n]).reshape(shape)
        mesh = jax.sharding.Mesh(devs, tuple(axes))
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        m = NamedSharding(mesh, spec).devices_indices_map(tuple(gshape))
        blocks = []
        for coord in np.ndindex(*shape):
            idx = m[devs[coord]]
            blocks.append([list(coord), [[s.start or 0, s.stop if
                           s.stop is not None else g] for s, g in
                           zip(idx, gshape)]])
        out.append(blocks)
    print(json.dumps(out))
""")


def test_multi_axis_local_blocks_match_named_sharding():
    """A dim split over a tuple of axes (deepseek-v3's experts over
    ("data", "model"), the batch over ("pod", "data")) is one Shard on
    each mesh dim; the block DTensor gives each mesh coordinate equals
    the block the reference's NamedSharding gives that device (8 forced
    CPU devices in a subprocess)."""
    cases = [((2, 2), ["data", "model"], [["data", "model"], None, None],
              [8, 6, 4]),
             ((2, 2, 2), ["pod", "data", "model"], [["pod", "data"], None],
              [8, 5]),
             ((2, 2, 2), ["pod", "data", "model"],
              [["pod", "data"], None, "model", None], [4, 3, 6, 2]),
             ((2, 4), ["data", "model"], [None, ["data", "model"]], [3, 16])]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", _BLOCKS, json.dumps(cases)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want_all = json.loads(res.stdout.strip().splitlines()[-1])

    class FakeMesh:
        def __init__(self, names, shape):
            self.mesh_dim_names, self.shape = tuple(names), tuple(shape)

    for (shape, axes, spec, gshape), want in zip(cases, want_all):
        spec = rules.Spec(*[tuple(e) if isinstance(e, list) else e
                            for e in spec])
        place = rules.placements(spec, FakeMesh(axes, shape))
        for coord, block in want:
            lshape, off = _compute_local_shape_and_global_offset(
                tuple(gshape), tuple(shape), list(coord), place)
            got = [[o, o + s] for o, s in zip(off, lshape)]
            assert got == block, (shape, spec, coord, got, block)
