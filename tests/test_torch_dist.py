"""The port's mesh-level FedNC collective (`core.dist`) on the CPU.

At world size 4 on gloo (four spawned processes over a `FileStore` in
the test's directory, each holding one client's update): every mode's
coded mean equals the plain mean, within the reference's bounds
(`tests/test_dist.py`: psum 1e-6, naive and blocked 1e-4), the
per-leaf matrices drawn from a generator seeded alike on every rank or
given as A.  At world size 1 (the port's one-card mesh, gloo): each
mode against `launch.steps.aggregate_gradients` given the same A, and
the blocked mode's zero padding to a multiple of K.
"""
import json
import multiprocessing as mp
import os

import pytest
import torch

from repro_torch.core import dist as tdist
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.steps import aggregate_gradients

WORLD = 4
JOIN_S = 120


def _updates(K: int) -> dict:
    """The (K, ...) client stacks every rank draws alike; leaf lengths
    165 and 7 are not multiples of K (the blocked mode pads)."""
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn((K, 33, 5), generator=g),
            "b": torch.randn((K, 7), generator=g)}


def _rank_main(rank: int, store: str, out_dir: str) -> None:
    """One rank: the coded mean of its slice in each mode; writes the
    largest |error| against the plain mean."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        full = _updates(WORLD)
        local = {k: v[rank:rank + 1] for k, v in full.items()}
        errs = {}
        for mode in tdist.MODES:
            f = tdist.make_fednc_mean(mode=mode)
            for how, kw in (("generator", {"generator":
                                           torch.Generator().manual_seed(7)}),
                            ("A", {"A": tdist.mix_matrix(
                                torch.Generator().manual_seed(3), WORLD)})):
                out = f(local, **kw)
                assert all(out[k].shape == local[k].shape for k in full)
                errs[f"{mode}/{how}"] = max(
                    float((out[k][0] - full[k].mean(0)).abs().max())
                    for k in full)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(errs, fh)
    finally:
        dist.destroy_process_group()


def test_coded_mean_at_world_size_4_on_gloo(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    for r in range(WORLD):
        errs = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert len(errs) == 2 * len(tdist.MODES)
        for key, err in errs.items():
            assert err < (1e-6 if key.startswith("psum") else 1e-4), (r, key)


@pytest.fixture
def one_card_mesh():
    mesh = tmesh.make_production_mesh(device="cpu")
    yield mesh
    tmesh.destroy_production_mesh()


@pytest.mark.parametrize("mode, agg", [("naive", "fednc_naive"),
                                       ("blocked", "fednc_blocked"),
                                       ("psum", "plain")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_world_size_1_equals_aggregate_gradients(one_card_mesh, mode, agg,
                                                 dtype):
    """K = 1 on the one-card mesh: the collectives are identities, and
    each mode gives `aggregate_gradients`' result for the same A (bf16:
    the same roundings), which is the update itself within the dtype's
    rounding."""
    tree = {k: v.to(dtype) for k, v in _updates(1).items()}
    A = torch.tensor([[1.7]])
    f = tdist.make_fednc_mean(one_card_mesh, axis="data", mode=mode)
    got = f(tree, A=A)
    want = aggregate_gradients(tree, None, 1, agg, A=A)
    for k in tree:
        assert got[k].shape == tree[k].shape and got[k].dtype == dtype
        torch.testing.assert_close(got[k][0], want[k], rtol=0, atol=0)
        torch.testing.assert_close(got[k][0].float(), tree[k][0].float(),
                                   rtol=1e-2 if dtype == torch.bfloat16
                                   else 1e-6, atol=1e-6)


def test_blocked_pads_to_a_multiple_of_k(one_card_mesh, monkeypatch):
    """The blocked body sees the update zero-padded to a multiple of K
    (the reference's `dist.py:74-79`) and the mean comes back cut to
    the leaf's length."""
    seen = []
    body = tdist._blocked_body
    monkeypatch.setattr(tdist, "_blocked_body", lambda u, A, **kw: (
        seen.append(u.clone()), body(u, A, **kw))[1])
    u = torch.arange(1.0, 8.0)
    out = tdist.fednc_mean_flat(u, torch.eye(1), K=1, mode="blocked")
    assert torch.equal(out, u) and seen[0].shape == (7,)
    padded = torch.nn.functional.pad(u, (0, (-7) % 4))
    assert padded.shape == (8,) and float(padded[-1]) == 0.0
    with pytest.raises(ValueError, match="unknown mode"):
        tdist.make_fednc_mean(one_card_mesh, mode="ring")
