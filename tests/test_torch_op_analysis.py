"""Roofline counts of dispatched torch ops (``repro_torch.launch.
op_analysis``): the torch forms of tests/test_hlo_analysis.py's cases,
then per-device counts of DTensor programs on a fake (4, 2) mesh against
a hand count. Eager torch runs every loop trip, so a loop's count is its
trips times its body's; there are no trip counts to read."""
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import op_analysis as A

META = torch.device("meta")


def empty(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_plain_matmul_flops_and_bytes_exact():
    a, b = empty(128, 256), empty(256, 64)
    r = A.analyze(lambda x, y: x @ y, a, b, device=META)
    assert r["flops_per_dev"] == 2 * 128 * 256 * 64
    # one mm: read a and b, write the result
    assert r["bytes_per_dev"] == 4 * (128 * 256 + 256 * 64 + 128 * 64)
    assert r["collective_bytes_per_dev"] == 0 and r["collectives"] == {}


def test_loop_counts_every_trip():
    def f(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    a, _ = A.count(f, empty(12, 64, 64), empty(8, 64), device=META)
    assert a.cost.flops == 12 * 2 * 8 * 64 * 64
    assert a.cost.eflops == 12 * 8 * 64          # tanh, 1 an element


def test_nested_loop_trip_product():
    def f(ws, x):
        for w in ws:
            for _ in range(5):
                x = torch.tanh(x @ w)
        return x

    a, _ = A.count(f, empty(3, 32, 32), empty(4, 32), device=META)
    assert a.cost.flops == 3 * 5 * 2 * 4 * 32 * 32


def test_remat_recompute_is_visible():
    """torch.utils.checkpoint's recompute runs, and is counted, in the
    backward: exactly one more forward product than without it."""
    def grad(remat):
        def fn(w, x):
            w = w.detach().requires_grad_(True)

            def block(x):
                return torch.tanh(x @ w)
            h = (checkpoint(block, x, use_reentrant=False) if remat
                 else block(x))
            torch.sum(h * h).backward()
            return w.grad
        return A.count(fn, empty(128, 128), empty(64, 128), device=META)[0]

    base, remat = grad(False), grad(True)
    assert base.cost.flops == 2 * (2 * 64 * 128 * 128)    # fwd + dW
    assert remat.cost.flops == base.cost.flops + 2 * 64 * 128 * 128


def test_slice_read_bytes_not_full_operand():
    """Reading 1 row of a big table must cost ~row bytes, not table
    bytes (a view, then the op on the row); an index read ~2x its
    result."""
    table = empty(4096, 512)
    r = A.analyze(lambda t: t[7] * 2.0, table, device=META)
    assert r["bytes_per_dev"] == 2 * 512 * 4
    idx = torch.zeros(3, dtype=torch.long, device=META)
    r = A.analyze(lambda t, i: torch.index_select(t, 0, i), table, idx,
                  device=META)
    assert r["bytes_per_dev"] == 2 * 3 * 512 * 4


def test_write_into_slice_costs_the_update():
    def f(buf, upd):
        buf[:, 10:12] = upd
        return buf

    buf, upd = empty(4, 4096, 8), empty(4, 2, 8)
    a, out = A.count(f, buf, upd, device=META)
    assert a.cost.bytes == 2 * upd.numel() * 4
    mem = a.memory(out)
    # the output is the argument, updated in place: aliased
    assert mem["alias_bytes"] == mem["output_bytes"] == buf.numel() * 4
    assert mem["argument_bytes"] == (buf.numel() + upd.numel()) * 4


def test_memory_analysis_of_a_product():
    a, b = empty(128, 256), empty(256, 64)
    an, out = A.count(lambda x, y: torch.tanh(x @ y), a, b, device=META)
    mem = an.memory(out)
    args = (128 * 256 + 256 * 64) * 4
    res = 128 * 64 * 4
    assert mem["argument_bytes"] == args
    assert mem["output_bytes"] == res and mem["alias_bytes"] == 0
    # x @ y and its tanh live together for a moment
    assert mem["peak_bytes"] == args + 2 * res
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"] - mem["alias_bytes"])


def test_other_devices_are_not_the_program():
    """Host work beside the program (the RNG state, a mesh's coordinate
    tensors) is not charged to the device counted."""
    def f(x):
        torch.arange(1000) * 2                      # host, not counted
        return x + 1
    a, _ = A.count(f, empty(10), device=META)
    assert a.cost.eflops == 10 and a.n_ops == 1


def test_top_contributors_ranks_matmul_first():
    def f(x, w):
        return torch.sum(torch.tanh(x @ w))

    top = A.top_contributors(f, empty(256, 512), empty(512, 512), n=3,
                             key="flops", device=META)
    assert top[0][0].endswith("/mm")
    assert top[0][1][0] == 2 * 256 * 512 * 512
    assert "test_torch_op_analysis" in top[0][0]


# --- per device, on a fake (4, 2) mesh ---------------------------------------
@pytest.fixture
def mesh():
    """A (data=4, model=2) mesh over a fake process group of 8 ranks,
    destroyed afterwards."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        pytest.fail("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (4, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def dtensor(mesh, shape, placements):
    """A meta DTensor of global ``shape``: this rank's shard."""
    local = list(shape)
    for m, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            local[p.dim] //= m
    return DTensor.from_local(empty(*local), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device=META).stride())


def test_dtensor_matmul_is_charged_at_local_shapes(mesh):
    """(1024, 4096) rows over data @ (4096, 14336) columns over model:
    each rank multiplies its (256, 4096) by its (4096, 7168), no
    collective; the global product would count 8x as much."""
    a = dtensor(mesh, (1024, 4096), [Shard(0), Replicate()])
    b = dtensor(mesh, (4096, 14336), [Replicate(), Shard(1)])
    an, out = A.count(lambda x, y: x @ y, a, b, device=META)
    assert isinstance(out, DTensor)
    assert an.cost.flops == 2 * 256 * 4096 * 7168
    assert an.cost.bytes == 4 * (256 * 4096 + 4096 * 7168 + 256 * 7168)
    assert an.analyze()["collectives"] == {}
    mem = an.memory(out)
    assert mem["argument_bytes"] == 4 * (256 * 4096 + 4096 * 7168)


@pytest.mark.parametrize("dim,n", [(0, 4), (1, 2)])
def test_one_all_reduce_ring_bytes(mesh, dim, n):
    """A partial sum over one mesh dim reduced to a replica: one
    all-reduce over that dim's n ranks, 2(n-1)/n of the local bytes."""
    pl = [Replicate(), Replicate()]
    pl[dim] = Partial()
    x = dtensor(mesh, (64, 128), pl)
    r = A.analyze(lambda t: t.redistribute(
        mesh, [Replicate(), Replicate()]).to_local(), x, device=META)
    size = 64 * 128 * 4
    assert r["collectives"] == {"all-reduce": {
        "count": 1.0, "bytes": 2 * (n - 1) / n * size}}
    assert r["collective_bytes_per_dev"] == 2 * (n - 1) / n * size


def test_all_gather_counts_the_gathered_result(mesh):
    x = dtensor(mesh, (64, 128), [Replicate(), Shard(0)])
    r = A.analyze(lambda t: t.full_tensor(), x, device=META)
    gathered = 64 * 128 * 4
    assert r["collectives"]["all-gather"] == {"count": 1.0,
                                              "bytes": 1 / 2 * gathered}
