"""Port parity, the multi-process programs: ``krylov.fgmres(group=)``, the
flexible ``velo_inner`` chunks on row strips (escalation step 1 included),
``fused=True`` and ``device_krylov=True`` under a process group,
``run_parallel(devices=)`` and ``make_group(dcn=)``.  Two processes over
gloo and one single process run the worker of
``tests/torch_parallel_worker.py`` on these cases; the two ranks must agree
bitwise, and they are held against the single process and, where stated,
against ``sem_tpu`` under ``use_mesh(make_mesh())`` on the 8 virtual
devices of tests/conftest.py.  ``run_parallel(velo_inner=5)`` is held in
``tests/test_torch_parallel_programs_jnk.py`` (JNK) and
``tests/test_torch_parallel_programs_ptc.py`` (PTC), each with its own
processes.  ``device="cpu"`` throughout; tolerances are stated per test."""
import numpy as np
import pytest

from tests.torch_parallel_worker import (QUICK, chunks_agree, close, fields,
                                         ranks_equal, run_workers)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's cases (a), (b), (d)–(h), with ``sem_tpu``'s fused mesh
    run: ``(results by tag, dir, sem_tpu's runs)``."""
    return run_workers(
        tmp_path_factory.mktemp("parallel_programs"),
        ["fgmres", "mixed5", "escalation", "fused", "devk", "devices", "dcn"],
        {"fused": (True, dict(mode="JNK", **QUICK))})


@pytest.mark.parametrize("varying", [0, 1], ids=["fixed", "varying"])
def test_fgmres_on_strips_matches_full(runs, varying):
    """(a) ``fgmres(group=)`` on this rank's strips against ``fgmres`` on
    the full vectors, with a fixed and with a varying right
    preconditioner: equal iterations, x within 1e-10 relative (f64)."""
    res, out, _ = runs
    name = f"fgmres{varying}"
    got = ranks_equal(out, name)
    assert res["rank0"][name] == res["rank1"][name] == res["single"][name]
    assert res["single"][name]["converged"]
    close(got, fields(out, name, "single"), 1e-10)


def test_flexible_strip_chunks_match_single_process(runs):
    """(b) ``_update_coupled_mixed(velo_inner=5)`` at a fixed
    linearization, two ranks against one process: both converge, x within
    1e-6 relative, the f32 chunks as :func:`chunks_agree` holds them (the
    second floors: 76 iterations in one process, 82 on the ranks); each
    rank ran halo exchanges, strip gathers and all-reduces."""
    res, out, _ = runs
    got = ranks_equal(out, "mixed5")
    r0, r1, single = (res[t]["mixed5"] for t in ("rank0", "rank1", "single"))
    assert r0 == r1
    assert r0["converged"] and single["converged"]
    chunks_agree(r0["chunks"], single["chunks"])
    assert all(n > 0 for n in r0["collectives"].values()), r0
    assert single["collectives"] == dict.fromkeys(r0["collectives"], 0)
    close(got, fields(out, "mixed5", "single"), 1e-6)


def test_escalation_step_1_under_the_group(runs):
    """(f) A plain solve that reports a floor escalates to the flexible
    ``velo_inner=5`` retry on the strips: one retry in each rank, adopted
    and converged (no f64 rescue), its x within 1e-6 relative of the same
    retry in one process, its f32 chunks as :func:`chunks_agree` holds
    them."""
    res, out, _ = runs
    got = ranks_equal(out, "retry")
    esc = [res[t]["escalation"] for t in ("rank0", "rank1", "single")]
    assert esc[0] == esc[1]
    for e in esc:
        assert (e["flex"], e["f64"], e["retries"]) == (1, 0, 1), e
        assert e["converged"], e
    chunks_agree(esc[0]["chunks"], esc[2]["chunks"])
    close(got, fields(out, "retry", "single"), 1e-6)


def test_fused_under_the_group_matches(runs):
    """(d) ``fused=True`` under the group against the port's single
    process and against ``sem_tpu``'s mesh run with both fused switches
    on: equal stats, the fields within 1e-6 relative; one fused step runs
    no collective."""
    res, out, jax = runs
    got = ranks_equal(out, "fused")
    assert res["rank0"]["fused"] == res["rank1"]["fused"] \
        == res["single"]["fused"]
    assert res["rank0"]["fused"]["stats"] == jax["fused"][0]["stats"]
    close(got, fields(out, "fused", "single"), 1e-6)
    close(got, jax["fused"][1], 1e-6)
    for t in ("rank0", "rank1"):
        assert res[t]["fused_step_collectives"] == {
            "halo_exchange": 0, "strip_gather": 0, "all_reduce": 0}


def test_fused_flexible_under_the_group_matches(runs):
    """(d) ``fused=True`` with ``velo_inner=5``: the two-round
    preconditioner over the flexible strip chunks, against the port's
    single process: equal stats and coupled GMRES iterations, the fields
    within 1e-6 relative."""
    res, out, _ = runs
    got = ranks_equal(out, "fused5")
    assert res["rank0"]["fused5"] == res["rank1"]["fused5"] \
        == res["single"]["fused5"]
    close(got, fields(out, "fused5", "single"), 1e-6)


def test_device_krylov_under_the_group_matches(runs):
    """(e) ``device_krylov=True`` under the group against the port's
    single process: equal stats and coupled GMRES iterations, the fields
    within 1e-6 relative (the windows' f64 solves are replicated; only the
    iteration-0 sweep's f32 chunks run on strips)."""
    res, out, _ = runs
    got = ranks_equal(out, "devk")
    assert res["rank0"]["devk"] == res["rank1"]["devk"] \
        == res["single"]["devk"]
    close(got, fields(out, "devk", "single"), 1e-6)


def test_run_parallel_devices_subset(runs):
    """(g) ``run_parallel(devices=[0])``: rank 0 solves alone, a group of
    one rank, so the single-device code, and equals the single process
    bitwise; rank 1 returns ``None``.  ``make_group([1])`` is ``None`` on
    rank 0 and a one-rank group on rank 1."""
    res, out, _ = runs
    assert res["rank0"]["devices0_none"] is False
    assert res["rank1"]["devices0_none"] is True
    assert "jnk" not in res["rank1"]
    assert res["rank0"]["jnk"] == res["single"]["jnk"]
    ref = fields(out, "jnk", "single")
    for k, a in fields(out, "jnk", "rank0").items():
        np.testing.assert_array_equal(a, ref[k])
    assert res["rank0"]["ranks1"] is None
    assert res["rank1"]["ranks1"] == [0, 1, [1]]


def test_make_group_dcn_on_one_host(runs):
    """(h) Both ranks on one host: ``make_group()`` is flat (``hosts`` is
    None) and ``make_group(dcn=True)`` raises ``ValueError``."""
    res, _, _ = runs
    for t in ("rank0", "rank1"):
        assert res[t]["hosts"] is None
        assert "only one host" in res[t]["dcn"], res[t]["dcn"]


class _Dist:
    """``torch.distributed`` of one process that believes it is ``rank`` of
    ``world`` ranks on the given hosts (what ``make_group`` reads)."""

    def __init__(self, rank, hosts):
        self.rank, self.hosts, self.groups = rank, hosts, []

    def is_initialized(self):
        return True

    def get_world_size(self):
        return len(self.hosts)

    def get_rank(self):
        return self.rank

    def get_backend(self, pg=None):
        return "fake"

    def all_gather_object(self, out, obj):
        out[:] = self.hosts

    def new_group(self, ranks):
        self.groups.append(ranks)
        return ("pg", tuple(ranks))


@pytest.mark.parametrize("hosts,dcn,want", [
    (["a", "b", "a", "b"], None, ((0, 2), (1, 3))),
    (["a", "b", "a", "b"], True, ((0, 2), (1, 3))),
    (["a", "b", "a", "b"], False, None),
    (["a", "a", "a", "b"], None, None),
    (["a", "a", "a", "b"], True, ValueError),
    (["a", "a", "a", "a"], True, ValueError)])
def test_make_group_host_layout(monkeypatch, hosts, dcn, want):
    """The two-level rules of ``sem_tpu``'s ``make_mesh(dcn=)``: automatic
    over more than one host with even counts per host, flat otherwise;
    ``dcn=True`` raises on one host or uneven counts.  A two-level group
    orders its strips host by host, and its all-gather returns the
    process group's outputs in that order."""
    import torch
    import torch.distributed as tdist
    from sem_tpu_torch.parallel import make_group

    fake = _Dist(1, hosts)
    for name in ("is_initialized", "get_world_size", "get_rank",
                 "get_backend", "all_gather_object", "new_group"):
        monkeypatch.setattr(tdist, name, getattr(fake, name))
    if want is ValueError:
        with pytest.raises(ValueError, match="dcn=True"):
            make_group(dcn=dcn)
        return
    g = make_group(dcn=dcn)
    assert g.hosts == want and g.world == 4 and fake.groups == []
    members = [0, 1, 2, 3] if want is None else [0, 2, 1, 3]
    assert g.members == members and g.rank == members.index(1)

    def all_gather(out, t, group=None):
        for i in range(len(out)):      # process-group order: by rank
            out[i].copy_(t + i)
    monkeypatch.setattr(tdist, "all_gather", all_gather)
    got = [int(t) for t in g.all_gather(torch.zeros(()))]
    assert got == members
    with pytest.raises(ValueError, match="subset"):
        make_group(ranks=[7])
