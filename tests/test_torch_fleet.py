"""GPU-fleet placement (``repro_torch.launch.fleet``) against the
reference ``repro.launch.fleet``.

With the reference's TPU ``GENERATIONS`` put into the port's table, every
function must give the reference's answers bit for bit on jobs and fleets
drawn from a numpy seed: the decision matrices, closeness, placements,
re-placements, queue placements with their chip accounting, and the jobs
read from the same dry-run records. Then the reference's ten behaviours
(tests/test_fleet.py) are restated on the port's own GPU table (L4, A100,
H100)."""
import json

import numpy as np
import pytest

from repro.launch import fleet as rfleet
from repro_torch.launch import fleet

SCHEMES = tuple(rfleet.FLEET_SCHEMES)


@pytest.fixture
def tpu_table(monkeypatch):
    """The reference's generations in the port's table."""
    monkeypatch.setattr(fleet, "GENERATIONS",
                        {k: dict(v) for k, v in rfleet.GENERATIONS.items()})
    return sorted(rfleet.GENERATIONS)


def draw(seed, gens, n_jobs=6, n_slices=5):
    """Jobs and slices (as constructor arguments) from a numpy seed."""
    rng = np.random.default_rng(seed)
    jobs = [("arch%d" % i, "shape%d" % i, int(rng.choice([64, 128, 256])),
             float(rng.uniform(0.1, 3.0)), float(rng.uniform(0.1, 3.0)),
             float(rng.uniform(0.0, 2.0)), float(rng.uniform(1e9, 40e9)))
            for i in range(n_jobs)]
    slices = []
    for i in range(n_slices):
        chips = int(rng.choice([256, 512]))
        slices.append(("s%d" % i, chips, int(rng.integers(0, chips + 1)),
                       gens[int(rng.integers(len(gens)))],
                       float(rng.choice([1.0, 1.0, 2.0])),
                       bool(rng.integers(2))))
    return jobs, slices


def both(jobs, slices):
    """The same jobs and slices in the reference's and the port's types."""
    return ([rfleet.Job(*j) for j in jobs], [rfleet.Slice(*s) for s in slices],
            [fleet.Job(*j) for j in jobs], [fleet.Slice(*s) for s in slices])


def slice_state(slices):
    return [(s.name, s.chips, s.free_chips, s.gen, s.health, s.awake)
            for s in slices]


def test_schemes_and_criteria_are_the_reference_s():
    assert list(fleet.FLEET_SCHEMES) == list(rfleet.FLEET_SCHEMES)
    for k in SCHEMES:
        np.testing.assert_array_equal(fleet.fleet_weights(k),
                                      rfleet.fleet_weights(k))
    np.testing.assert_array_equal(fleet._BENEFIT, rfleet._BENEFIT)


@pytest.mark.parametrize("seed", range(6))
def test_matrix_closeness_and_place_bitwise(tpu_table, seed):
    jobs, slices = draw(seed, tpu_table)
    rj, rs, pj, ps = both(jobs, slices)
    for a, b in zip(rj, pj):
        assert [rfleet.feasible(a, s) for s in rs] == \
            [fleet.feasible(b, s) for s in ps]
        for s, t in zip(rs, ps):
            assert rfleet.job_on_slice(a, s) == fleet.job_on_slice(b, t)
        want = rfleet.decision_matrix(a, rs)
        got = fleet.decision_matrix(b, ps)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for scheme in SCHEMES:
            ri, rd = rfleet.place(a, rs, scheme)
            pi, pd = fleet.place(b, ps, scheme)
            assert ri == pi
            assert rd.keys() == pd.keys()
            if "closeness" in rd:
                np.testing.assert_array_equal(pd["closeness"],
                                              rd["closeness"])
                np.testing.assert_array_equal(pd["matrix"], rd["matrix"])


@pytest.mark.parametrize("seed", range(4))
def test_schedule_queue_and_replace_slice_bitwise(tpu_table, seed):
    jobs, slices = draw(seed, tpu_table, n_jobs=10)
    for scheme in SCHEMES:
        rj, rs, pj, ps = both(jobs, slices)
        want = rfleet.schedule_queue(rj, rs, scheme)
        got = fleet.schedule_queue(pj, ps, scheme)
        assert [i for _, i in got] == [i for _, i in want]
        assert slice_state(ps) == slice_state(rs)
        for a, b in zip(rj, pj):
            cur = rfleet.place(a, rs, scheme)[0]
            if cur is None:
                continue
            assert rfleet.replace_slice(a, rs, cur, scheme) == \
                fleet.replace_slice(b, ps, cur, scheme)
            assert slice_state(ps) == slice_state(rs)


def test_load_jobs_bitwise(tmp_path):
    rng = np.random.default_rng(7)
    for i in range(5):
        rec = {"arch": f"a{i}", "shape": "train_4k", "mesh": "single",
               "chips": 256, "ok": bool(i % 4),
               "roofline": {"compute_s": float(rng.uniform()),
                            "memory_s": float(rng.uniform()),
                            "collective_s": float(rng.uniform()),
                            "dominant": "memory_s"},
               "memory": {"peak_bytes": float(rng.uniform(1e9, 9e10))}}
        (tmp_path / f"a{i}__train_4k__single.json").write_text(
            json.dumps(rec))
    (tmp_path / "a9__train_4k__multi.json").write_text(json.dumps(rec))
    for mesh in ("single", "multi"):
        want = rfleet.load_jobs(str(tmp_path), mesh)
        got = fleet.load_jobs(str(tmp_path), mesh)
        assert [tuple(vars(j).values()) for j in got] == \
            [tuple(vars(j).values()) for j in want]
        assert [j.step_time_s for j in got] == [j.step_time_s for j in want]
        assert [j.utilization() for j in got] == \
            [j.utilization() for j in want]


def test_validation_messages_word_for_word(tpu_table):
    job = rfleet.Job("a", "s", 256, 1.0, 2.0, 0.5, 8e9)
    pjob = fleet.Job("a", "s", 256, 1.0, 2.0, 0.5, 8e9)
    tight = dict(name="s", chips=256, free_chips=0, gen="v5e")
    with pytest.raises(AssertionError):
        rfleet.bind(job, rfleet.Slice(**tight))
    with pytest.raises(AssertionError):
        fleet.bind(pjob, fleet.Slice(**tight))
    with pytest.raises(KeyError) as want:
        rfleet.fleet_weights("nope")
    with pytest.raises(KeyError) as got:
        fleet.fleet_weights("nope")
    assert str(got.value) == str(want.value)
    assert fleet.place(pjob, [fleet.Slice(**tight)])[1] == \
        rfleet.place(job, [rfleet.Slice(**tight)])[1] == \
        {"reason": "unschedulable"}


# --- the reference's behaviours on the port's GPU table ---------------------
def mk_job(chips=256, comp=1.0, mem=2.0, coll=0.5, peak=8e9,
           arch="llama3-8b", shape="train_4k"):
    return fleet.Job(arch, shape, chips, comp, mem, coll, peak)


def mk_fleet():
    return [fleet.Slice("l0", 256, 256, "l4"),
            fleet.Slice("h0", 256, 256, "h100"),
            fleet.Slice("a0", 256, 256, "a100")]


def test_gpu_table_is_cited_datasheet_data():
    g = fleet.GENERATIONS
    assert set(g) == {"l4", "a100", "h100"}
    assert g["h100"]["speed"] == 1.0
    assert g["l4"]["speed"] == pytest.approx(121 / 989)
    assert g["a100"]["speed"] == pytest.approx(312 / 989)
    assert [g[k]["hbm"] for k in ("l4", "a100", "h100")] == [24e9, 80e9,
                                                              80e9]
    assert [g[k]["tdp"] for k in ("l4", "a100", "h100")] == [72.0, 400.0,
                                                              700.0]
    assert fleet.Slice("s", 8, 8).gen == "h100"


def test_feasibility_chips_and_hbm():
    job = mk_job(chips=256, peak=8e9)
    assert fleet.feasible(job, fleet.Slice("s", 256, 256, "l4"))
    assert not fleet.feasible(job, fleet.Slice("s", 256, 128, "l4"))
    # 30 GB/GPU peak: too big for the L4 (24 GB), fits the H100 (80 GB)
    big = mk_job(peak=30e9)
    assert not fleet.feasible(big, fleet.Slice("s", 256, 256, "l4"))
    assert fleet.feasible(big, fleet.Slice("s", 256, 256, "h100"))


def test_job_on_slice_physics():
    job = mk_job(comp=1.0, mem=2.0, coll=0.5)
    lo = fleet.Slice("l", 256, 256, "l4", awake=True)
    hi = fleet.Slice("h", 256, 256, "h100", awake=True)
    step_l, en_l = fleet.job_on_slice(job, lo)
    step_h, en_h = fleet.job_on_slice(job, hi)
    assert step_h < step_l                       # the H100 is faster
    assert en_h > en_l * 0.5              # but not proportionally frugal
    # waking an idle slice costs extra energy
    l_idle = fleet.Slice("l2", 256, 256, "l4", awake=False)
    _, en_wake = fleet.job_on_slice(job, l_idle)
    assert en_wake > en_l


def test_energy_vs_performance_scheme_preference():
    """Energy-centric prefers the frugal class, performance-centric the
    fast one (paper §V.D: class A vs class C). With datasheet speeds the
    H100 leads both schemes (a compute-bound step costs within 7% of the
    L4's energy at an 8x shorter step); among the L4 and the A100,
    energy-centric takes the L4 and performance-centric the A100."""
    job = mk_job(comp=2.0, mem=1.0, peak=2e9)
    energy = [fleet.job_on_slice(job, s)[1] for s in mk_fleet()]
    assert mk_fleet()[int(np.argmin(energy))].gen == "l4"
    for scheme in ("energy_centric", "performance_centric"):
        idx, _ = fleet.place(job, mk_fleet(), scheme)
        assert mk_fleet()[idx].gen == "h100"
    no_h100 = [s for s in mk_fleet() if s.gen != "h100"]
    ie, _ = fleet.place(job, no_h100, "energy_centric")
    ip, _ = fleet.place(job, no_h100, "performance_centric")
    assert no_h100[ie].gen == "l4"
    assert no_h100[ip].gen == "a100"


def test_memory_tight_job_resource_efficient_moves_off():
    """A job that nearly fills the L4's 24 GB: resource-efficient
    weighting moves off the tight slice; energy-centric still places
    it."""
    job = mk_job(peak=22e9)
    ir, _ = fleet.place(job, mk_fleet(), "resource_efficient")
    assert mk_fleet()[ir].gen != "l4"
    ie, _ = fleet.place(job, mk_fleet(), "energy_centric")
    assert ie is not None


def test_consolidation_prefers_awake_slice():
    job = mk_job(chips=64)
    slices = [fleet.Slice("a", 256, 256, "h100", awake=False),
              fleet.Slice("b", 256, 192, "h100", awake=True)]
    idx, _ = fleet.place(job, slices, "energy_centric")
    assert slices[idx].awake


def test_place_avoids_degraded_slice():
    job = mk_job()
    slices = [fleet.Slice("a", 256, 256, "h100"),
              fleet.Slice("b", 256, 256, "h100")]
    slices[0].degrade(10.0)
    idx, _ = fleet.place(job, slices)
    assert idx == 1


def test_replace_slice_moves_away():
    job = mk_job()
    slices = mk_fleet()
    cur, _ = fleet.place(job, slices)
    new = fleet.replace_slice(job, slices, current=cur)
    assert slices[cur].health > 1.0
    assert new != cur


def test_schedule_queue_accounts_chips():
    jobs = [mk_job() for _ in range(3)]
    slices = mk_fleet()            # 3 x 256 GPUs
    placed = fleet.schedule_queue(jobs, slices)
    assert all(idx is not None for _, idx in placed)
    assert sum(s.free_chips for s in slices) == 0
    idx, diag = fleet.place(mk_job(), slices)
    assert idx is None and diag["reason"] == "unschedulable"


def test_unschedulable_when_memory_everywhere_too_small():
    job = mk_job(peak=200e9)
    idx, _ = fleet.place(job, mk_fleet())
    assert idx is None


def test_load_jobs_from_dryrun(tmp_path):
    rec = {"arch": "llama3-8b", "shape": "train_4k", "mesh": "single",
           "chips": 256, "ok": True,
           "roofline": {"compute_s": 1.0, "memory_s": 2.0,
                        "collective_s": 0.5, "dominant": "memory_s"},
           "memory": {"peak_bytes": 8e9}}
    (tmp_path / "llama3-8b__train_4k__single.json").write_text(
        json.dumps(rec))
    (tmp_path / "bad__x__single.json").write_text(json.dumps(
        {"ok": False, "arch": "x", "shape": "y"}))
    jobs = fleet.load_jobs(str(tmp_path))
    assert len(jobs) == 1
    assert jobs[0].step_time_s == 2.0
    assert jobs[0].utilization() == pytest.approx(0.5)
