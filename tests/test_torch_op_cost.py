"""The op-level cost counter (``roofline/op_cost.py``), the port's
counterpart of the JAX package's HLO parser, against counts worked out by
hand; the fused traffic model and ``analysis.analyze`` on top of it; and
the depth extrapolation of ``launch/dryrun.py``.  No JAX.

Counts on a mesh run in spawned processes, each made rank 0 of a fake
world (``launch.mesh.fake_world``), with the bodies in
``tests/test_torch_dist_ranks.py``:

  * the JAX package's ``test_scan_flops_and_collectives_exact`` loop (7
    products of (256, 2048) by (2048, 2048) on a (2, 2) mesh): exact flops
    per device, and 6, not 7, all-gathers of the (128, 2048) carry per
    device: eager, the first product's operand starts with its contraction
    dim whole, where XLA's loop carries one layout through all 7 trips;
    and one elementwise op's traffic at its local shape;
  * each collective the port issues, functional and c10d, at its XLA
    result bytes, ``wait_tensor`` counting nothing;
  * reduced cells counted on ``meta`` stand-ins and on zero-filled cpu
    tensors, equal;
  * for every family the dry run extrapolates (all but the hybrid, which
    it counts at full depth), the count at 6 layers equal to the one
    extrapolated from 3 and 4, for train, prefill and decode cells.
"""
import concurrent.futures
import multiprocessing

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import record_function

import test_torch_dist_ranks as ranks
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis, fused_model
from repro_torch.roofline.op_cost import OpCost, count

F32 = 4
FAMILIES = {"dense": "tinyllama-1.1b", "vlm": "internvl2-1b",
            "audio": "musicgen-large", "moe": "deepseek-moe-16b",
            "moe_ring": "mixtral-8x7b", "ssm": "falcon-mamba-7b"}
KINDS = ("train", "prefill", "decode")
DEPTH_CELLS = {f"{fam}/{kind}": [arch, kind, {"n_layers": 6}, 32, 8]
               for fam, arch in FAMILIES.items() for kind in KINDS}
# reduced cells counted on meta and on cpu stand-ins (a "cpu" mesh)
STAND_IN_CELLS = {
    "dense/train": ["tinyllama-1.1b", "train", {"n_kv_heads": 2}, 32, 8],
    "moe/train": ["deepseek-moe-16b", "train", {}, 32, 8],
    "ssm/prefill": ["falcon-mamba-7b", "prefill", {}, 32, 8],
    "hybrid/decode": ["zamba2-1.2b", "decode", {}, 32, 8],
}


@pytest.fixture(scope="module")
def fake():
    """The fake-world counts, each in a process of its own, in parallel."""
    ctx = multiprocessing.get_context("spawn")
    jobs = {"loop": (ranks.fake_scan_loop, "meta"),
            "loop_cpu": (ranks.fake_scan_loop, "cpu"),
            "collectives": (ranks.fake_collectives,),
            "meta": (ranks.fake_cell_counts, STAND_IN_CELLS, 2, 4, "meta",
                     "cpu"),
            "cpu": (ranks.fake_cell_counts, STAND_IN_CELLS, 2, 4, "cpu",
                    "cpu"),
            "depth": (ranks.fake_depth_extrapolation, DEPTH_CELLS, 2, 4)}
    with concurrent.futures.ProcessPoolExecutor(
            4, mp_context=ctx, max_tasks_per_child=1) as pool:
        futs = {k: pool.submit(*v) for k, v in jobs.items()}
        return {k: f.result(timeout=300) for k, f in futs.items()}


def _bytes(*shapes, size=F32):
    total = 0
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        total += n * size
    return total


def test_matmul_flops_and_traffic():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    out, cost = count(torch.mm, a, b)
    assert torch.equal(out, a @ b)
    assert cost.flops == 2 * 64 * 32 * 16
    assert cost.traffic_bytes == _bytes((64, 32), (32, 16), (64, 16))
    assert cost.collective_bytes == {}


def test_matmul_class_flops():
    x, w, bias = torch.randn(8, 32), torch.randn(32, 16), torch.randn(16)
    assert count(torch.addmm, bias, x, w)[1].flops == 2 * 8 * 32 * 16
    p, q = torch.randn(4, 8, 16), torch.randn(4, 16, 2)
    assert count(torch.bmm, p, q)[1].flops == 2 * 4 * 8 * 16 * 2
    # the einsum lowers to a bmm
    assert count(torch.einsum, "bij,bjk->bik", p, q)[1].flops \
        == 2 * 4 * 8 * 16 * 2
    c = torch.randn(4, 8, 2)
    assert count(torch.baddbmm, c, p, q)[1].flops == 2 * 4 * 8 * 16 * 2
    # conv1d: (1, 4, 10) by (8, 4, 3) -> (1, 8, 8), 4 * 3 MACs an output
    sig, ker = torch.randn(1, 4, 10), torch.randn(8, 4, 3)
    assert count(F.conv1d, sig, ker)[1].flops == 2 * 8 * 8 * 4 * 3
    # elementwise ops do no counted flops
    assert count(torch.add, x, x)[1].flops == 0


def test_views_count_nothing():
    x = torch.randn(8, 16)

    def views(x):
        return (x.t(), x.view(16, 8), x[:, :4], x.transpose(0, 1),
                x.reshape(2, 64), x.unsqueeze(0).expand(3, 8, 16),
                x.detach(), x.chunk(2))

    _, cost = count(views, x)
    assert cost.traffic_bytes == 0 and cost.flops == 0


def test_elementwise_traffic_reads_each_operand_once():
    x, y = torch.randn(8, 8), torch.randn(8, 8)
    assert count(torch.add, x, y)[1].traffic_bytes == 3 * _bytes((8, 8))
    # x * x reads x once
    assert count(torch.mul, x, x)[1].traffic_bytes == 2 * _bytes((8, 8))
    # an in-place op reads and writes its target
    z = torch.zeros(8, 8)
    assert count(z.add_, y)[1].traffic_bytes == 3 * _bytes((8, 8))


def test_gathers_and_scatters_move_their_region():
    table, idx = torch.randn(100, 16), torch.tensor([3, 1, 4, 1, 5])
    region = _bytes((5, 16))
    assert count(lambda: table[idx])[1].traffic_bytes \
        == 2 * region + 5 * 8
    assert count(F.embedding, idx, table)[1].traffic_bytes \
        == 2 * region + 5 * 8
    values = torch.randn(5, 16)

    def write():
        table[idx] = values

    assert count(write)[1].traffic_bytes == 2 * region + 5 * 8


def test_scopes_tag_ops_by_the_innermost_one():
    a, b = torch.randn(16, 8), torch.randn(8, 4)
    mm = _bytes((16, 8), (8, 4), (16, 4))

    def fn():
        with record_function("outer"):
            torch.mm(a, b)
            with record_function("flash_attention_kernel"):
                torch.mm(a, b)
                a + a
            a * 2
        torch.mm(a, b)

    _, cost = count(fn)
    add = 2 * _bytes((16, 8))
    assert cost.scope_traffic == {"outer": mm + add,
                                  "flash_attention_kernel": mm + add}
    assert cost.scope_dot_bytes == {"outer": mm,
                                    "flash_attention_kernel": mm}
    assert cost.flops == 3 * 2 * 16 * 8 * 4


def test_peak_live_bytes():
    x = torch.randn(64, 64)

    def fn(x):
        y = x + 1  # 16 KiB
        z = y * 2  # 16 KiB, y still alive
        del y
        return z.sum()

    _, cost = count(fn, x)
    assert cost.peak_live_bytes == 2 * _bytes((64, 64))


def test_scan_flops_and_collectives_exact(fake):
    """The JAX package's test_scan_flops_and_collectives_exact on a fake
    (2, 2) mesh: flops per device exact; 6 all-gathers of the carry where
    XLA counts 7 (eager, the first product needs none)."""
    cost, one_op = fake["loop"]
    assert cost["flops"] == 2 * 256 * 2048 * 2048 * 7 / 4
    assert cost["collective_bytes"] == {"all-gather": 6 * 128 * 2048 * F32}
    assert fake["loop_cpu"] == (cost, one_op)
    # w * 2 on w's (2048, 1024) local shard of the (2048, 2048) global:
    # the shard read and written once, nothing gathered
    assert one_op["traffic_bytes"] == 2 * _bytes((2048, 1024))
    assert one_op["collective_bytes"] == {}


def test_collectives_both_families(fake):
    x = _bytes((8, 4))
    want = {"all-reduce": x, "all-gather": 4 * x, "reduce-scatter": x // 4,
            "all-to-all": x}
    got = fake["collectives"]
    assert got["functional"]["collective_bytes"] == want
    assert got["c10d"]["collective_bytes"] == dict(
        want, **{"collective-permute": x})
    # a collective waited three times counts once; the waits move nothing
    assert got["waits"]["collective_bytes"] == {"all-reduce": x}
    assert got["waits"]["traffic_bytes"] == 2 * x


@pytest.mark.parametrize("cell", list(STAND_IN_CELLS))
def test_meta_stand_ins_count_as_cpu_tensors(fake, cell):
    meta, cpu = fake["meta"][cell], fake["cpu"][cell]
    assert meta["flops"] > 0
    for key in ("flops", "traffic_bytes", "collective_bytes",
                "scope_traffic", "scope_dot_bytes"):
        assert meta[key] == cpu[key], key


@pytest.mark.parametrize("family", list(FAMILIES))
def test_depth_extrapolation_is_exact(fake, family):
    for kind in KINDS:
        run = fake["depth"][f"{family}/{kind}"]
        assert run["depths"] == [dryrun.DEPTH, dryrun.DEPTH + 1]
        full, ext = run["full"], run["extrapolated"]
        for key in ("flops", "traffic_bytes", "collective_bytes",
                    "scope_traffic", "scope_dot_bytes"):
            assert ext[key] == full[key], (kind, key)


def test_depths_count_the_hybrid_whole():
    assert dryrun.depths(get_config("zamba2-1.2b"), 3) == (38,)
    assert dryrun.depths(get_config("tinyllama-1.1b"), 3) == (3, 4)
    assert dryrun.depths(get_config("tinyllama-1.1b"), 0) == (22,)


def test_fused_memory_term_follows_the_jax_rule():
    cost = OpCost(traffic_bytes=1000.0,
                  scope_traffic={"flash_attention_kernel": 600.0,
                                 "selective_scan_kernel": 100.0,
                                 "other": 50.0},
                  scope_dot_bytes={"flash_attention_kernel": 200.0,
                                   "other": 40.0})
    info = fused_model.scoped_traffic(cost)
    assert info["scoped"] == {"flash_attention_kernel": 600.0,
                              "selective_scan_kernel": 100.0}
    assert info["interface"] == {"flash_attention_kernel": 50.0,
                                 "selective_scan_kernel": 0.0}
    t, meta = fused_model.fused_memory_term(1000.0, cost)
    assert meta == {"removed_bytes": 700.0, "added_bytes": 50.0,
                    "adjusted_traffic": 350.0}
    assert t == 350.0 / analysis.H100_HBM_BW


def test_analyze_builds_the_report_from_a_cost():
    cfg = get_config("tinyllama-1.1b")
    cost = OpCost(flops=2e12, traffic_bytes=3e9,
                  collective_bytes={"all-gather": 5e8, "all-reduce": 1e8})
    rep = analysis.analyze("tinyllama-1.1b", "train_4k", "pod16x16", 256,
                           cost, cfg, SHAPES["train_4k"])
    assert rep.flops_per_device == 2e12
    assert rep.bytes_per_device == 3e9
    assert rep.collective_bytes_per_device == 6e8
    assert rep.collective_breakdown == {"all-gather": 500000000,
                                        "all-reduce": 100000000}
    assert rep.t_compute == 2e12 / analysis.H100_PEAK_FLOPS_BF16
    assert rep.bottleneck == "compute"
    assert rep.model_flops == analysis.model_flops_estimate(
        cfg, SHAPES["train_4k"])
    assert analysis.collective_bytes_per_device(cost) == \
        rep.collective_breakdown
