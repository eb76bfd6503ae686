"""The port's sharding rules and placements against the JAX package's.

  * ``param_specs``: pure functions of the mesh's ``{axis: size}`` in both
    packages, so they are compared in this process without ranks (the
    reference's ``MeshContext`` over a stand-in with its mesh's ``shape``
    and ``axis_names``): for every config at ``reduced()`` size, on
    (data=4, model=2), (data=2, model=4), (pod=2, data=2, model=2) and
    (data=4, model=2) without FSDP, every leaf's spec equal, in JAX's leaf
    order;
  * placements: on 8 gloo ranks of (pod=2, data=2, model=2), each rank's
    local shard of a few leaves (a batch sharded over ('pod', 'data'),
    the embedding, a projection, EP expert weights, logits) equals, bit
    for bit, the shard JAX's device at the same mesh position holds
    (``addressable_shards`` in a subprocess with 8 forced host devices);
  * under a (data=2, model=2) mesh a bf16 ``fused`` policy matmul of
    DTensor operands equals the unsharded plain version bitwise (K1's
    plain version on each rank's replicated operands), and the K1 wrapper
    refuses a DTensor;
  * ``shard()`` returns its argument itself with no mesh;
  * ``decode_step`` and ``prefill_chunk``, which write the plain cache in
    place, raise under a mesh.
"""
import concurrent.futures
import pickle
import types

import numpy as np
import pytest
import torch

from helpers import run_multidevice
import test_torch_dist_ranks as ranks
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch.mesh import spawn
from repro_torch.models import LM
from repro_torch.parallel import sharding as sh
from repro_torch.train import tree

MESHES = {"4x2": ({"data": 4, "model": 2}, True),
          "2x4": ({"data": 2, "model": 4}, True),
          "2x2x2": ({"pod": 2, "data": 2, "model": 2}, True),
          "4x2-nofsdp": ({"data": 4, "model": 2}, False)}


def _jax_specs(arch, axes, fsdp):
    import jax
    from repro.configs.base import get_config as jget_config
    from repro.models import LM as JLM
    from repro.parallel import sharding as jsh
    from jax.sharding import PartitionSpec
    mesh = types.SimpleNamespace(shape=dict(axes), axis_names=tuple(axes))
    ctx = jsh.make_context(mesh, fsdp=fsdp)
    cfg = jget_config(arch).reduced()
    shapes = jax.eval_shape(JLM(cfg).init, jax.random.key(0))
    specs = jsh.param_specs(shapes, cfg.n_experts, ctx)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return ["/".join(str(k.key) for k in path) for path, _ in flat], \
        [tuple(s) for _, s in flat]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, mesh):
    axes, fsdp = MESHES[mesh]
    cfg = get_config(arch).reduced()
    params = LM(cfg, device="meta").init(0)
    specs = sh.param_specs(params, cfg.n_experts,
                           sh.make_context(axes, fsdp=fsdp))
    paths, want = _jax_specs(arch, axes, fsdp)
    assert tree.paths(params) == paths
    assert [s.entries for s in tree.leaves(specs)] == want


def test_shard_is_a_noop_without_a_mesh():
    x = torch.ones((4, 4))
    assert sh.shard(x, "batch", None) is x
    assert sh.active() is None and sh.tensor_size() == 1
    specs = sh.param_specs({"layers": {"wq": torch.zeros((4, 8, 16)),
                                       "scale": torch.zeros((2, 16))}})
    assert all(s == sh.P() for s in tree.leaves(specs))


@pytest.mark.parametrize("entry", ["decode_step", "prefill_chunk"])
def test_cache_writers_refuse_a_mesh(entry):
    """Decode and chunked prefill write the plain cache in place: under a
    mesh they raise before touching it, and the cache stays as it was."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = LM(cfg, device="cpu")
    params = model.init(0)
    cache = model.init_cache(2, 8)
    before = cache.data["k"].clone()
    tokens = torch.zeros((2, 1), dtype=torch.int64)
    args = {"decode_step": (tokens,),
            "prefill_chunk": (tokens, [0, 0], [1, 1], [0, 1])}[entry]
    with sh.use_mesh(sh.make_context({"data": 2, "model": 1})):
        with pytest.raises(RuntimeError, match="under a mesh"):
            getattr(model, entry)(params, cache, *args)
    assert torch.equal(cache.data["k"], before)


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    axes = {"pod": 2, "data": 2, "model": 2}
    assert sh.placements(sh.P(("pod", "data"), None, "model"), axes) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(None, "data"), axes) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements(sh.P(("data", "pod")), axes)


_JAX_SHARDS = """
import pickle
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh(pod=2, data=2, model=2)
with open(IN, "rb") as f:
    arrays, specs = pickle.load(f)
out = {}
for name, arr in arrays.items():
    x = jax.device_put(arr, NamedSharding(mesh, P(*specs[name])))
    by_dev = {s.device.id: np.asarray(s.data) for s in x.addressable_shards}
    out[name] = [by_dev[d.id] for d in mesh.devices.flat]
with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


def _leaves():
    """A few arrays and the port's specs for them on (pod=2, data=2,
    model=2)."""
    ctx = sh.make_context({"pod": 2, "data": 2, "model": 2})
    rng = np.random.default_rng(0)
    arrays, specs = {}, {}
    for arch, names in (("tinyllama-1.1b", ("embed", "layers/wq")),
                        ("deepseek-moe-16b", ("layers/moe/w_gate",
                                              "layers/moe/w_down"))):
        cfg = get_config(arch).reduced()
        params = LM(cfg, device="meta").init(0)
        pspecs = dict(zip(tree.paths(params), tree.leaves(
            sh.param_specs(params, cfg.n_experts, ctx))))
        for name, leaf in zip(tree.paths(params), tree.leaves(params)):
            if name in names:
                arrays[name] = rng.standard_normal(
                    tuple(leaf.shape)).astype(np.float32)
                specs[name] = pspecs[name].entries
    arrays["batch"] = rng.integers(0, 256, (8, 32)).astype(np.int32)
    arrays["logits"] = rng.standard_normal((8, 4, 256)).astype(np.float32)
    for name, logical in (("batch", ("batch", None)),
                          ("logits", ("batch", None, "tensor"))):
        specs[name] = sh.spec_for(logical, arrays[name].shape, ctx).entries
    return arrays, specs


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    arrays, specs = _leaves()
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((arrays, specs), f)
    code = f"IN = {str(d / 'in.pkl')!r}\nOUT = {str(d / 'out.pkl')!r}\n" \
        + _JAX_SHARDS
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_multidevice, code, 8)
        port = spawn(ranks.local_shards, 8, arrays, specs, timeout=120)
        jax_side.result()
    with open(d / "out.pkl", "rb") as f:
        return specs, port, pickle.load(f)


@pytest.mark.parametrize("name", ["batch", "embed", "layers/wq",
                                  "layers/moe/w_gate", "layers/moe/w_down",
                                  "logits"])
def test_local_shards_are_jax_device_shards(shards, name):
    specs, port, ref = shards
    assert any(e is not None for e in specs[name])
    for r in range(8):
        assert port[r][name].dtype == ref[name][r].dtype
        assert np.array_equal(port[r][name], ref[name][r]), r


def test_policy_matmul_on_a_mesh_is_the_plain_version():
    from repro_torch.models.numerics import EmulatedPolicy
    from repro_torch.numerics.emulate import policy_matmul
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    want = policy_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         EmulatedPolicy("bf16", "fused")).numpy()
    got = spawn(ranks.policy_matmul_on_mesh, 4, x, w, timeout=120)
    for r in got:
        assert r["in_placements"] == [["S(0)", "S(2)"], ["S(0)", "S(1)"]]
        assert r["placements"] == ["R", "R"]
        assert np.array_equal(r["out"], want)
        assert "DTensor" in r["refused"]
