"""The GNNs on the card, held to the host: each arch's smoke step and a
larger forward with every gradient leaf, cuda against cpu within ``1e-4 *
(1 + |cpu|)`` (``index_add_`` and ``index_select``'s backward add with
atomics on the card, so the sums agree to a tolerance, not bitwise); the
neighbour sampler's ids bitwise; the embedding bags; GraphCast's dst-
partitioned processor and ``sharded_aggregate`` on a 2x2 mesh of the card
against the single-device forms.

Every test needs a CUDA device and skips without one; the file imports
neither JAX nor the JAX package:
``python -m pytest -q -m cuda tests/test_torch_gnn_cuda.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.graphs import rmat_graph  # noqa: E402
from repro_torch.graphs.partition import partition_edges_by_dst  # noqa: E402
from repro_torch.graphs.sampler import (  # noqa: E402
    neighbor_sampler, sample_blocks,
)
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    tree_leaves, tree_map, value_and_grad,
)
from repro_torch.models.gnn import (  # noqa: E402
    egnn, equiformer, graphcast, graphsage, mpnn,
)
from repro_torch.sparse.embedding_bag import embedding_bag  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-4
ARCHS = ("graphsage-reddit", "egnn", "graphcast", "equiformer-v2")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    err = ((got - want).abs() / (1 + want.abs())).max()
    assert float(err) <= tol, float(err)


def _close_trees(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_step_cuda_equals_cpu(cuda, arch):
    a = get_arch(arch)
    p = a.init_fn(torch.Generator().manual_seed(0), a.smoke_config,
                  device="cpu")
    host = a.smoke_step(p, a.smoke_config, prng.PRNGKey(1))
    card = a.smoke_step(tree_map(lambda t: t.to(cuda), p), a.smoke_config,
                        prng.PRNGKey(1))
    for k in host:
        if k == "grads":
            _close_trees(card[k], host[k])
        else:
            _close(card[k], host[k])


def _inputs(n, e, d_feat, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, d_feat), generator=g),
            torch.randn((n, 3), generator=g),
            torch.randint(0, n, (e,), generator=g),
            torch.randint(0, n, (e,), generator=g))


def _both(cuda, loss_fn, params, cfg, *args, **kw):
    host = value_and_grad(loss_fn, params, cfg, *args, **kw)
    card = value_and_grad(loss_fn, tree_map(lambda t: t.to(cuda), params),
                          cfg, *(a.to(cuda) if isinstance(a, torch.Tensor)
                                 else a for a in args), **kw)
    _close(card[0], host[0])
    _close_trees(card[1], host[1])


def test_graphsage_edges_cuda_equals_cpu(cuda):
    cfg = dataclasses.replace(get_arch("graphsage-reddit").smoke_config,
                              d_feat=24)
    p = graphsage.init_sage(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    nf, _, es, ed = _inputs(256, 2048, 24)
    labels = torch.randint(0, cfg.n_classes, (256,),
                           generator=torch.Generator().manual_seed(1))
    _both(cuda, graphsage.loss_edges, p, cfg, nf, es, ed, labels, 256)


def test_egnn_cuda_equals_cpu(cuda):
    cfg = get_arch("egnn").smoke_config
    p = egnn.init_egnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    nf, pos, es, ed = _inputs(256, 2048, cfg.d_feat)
    _both(cuda, egnn.loss_edges, p, cfg, nf, pos, es, ed, pos * 0.9, 256)


@pytest.mark.parametrize("remat_group", [1, 2])
def test_graphcast_cuda_equals_cpu(cuda, remat_group):
    cfg = dataclasses.replace(get_arch("graphcast").smoke_config,
                              remat=True, remat_group=remat_group)
    p = graphcast.init_graphcast(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    nf, _, es, ed = _inputs(256, 2048, cfg.n_vars)
    ef = torch.randn((2048, cfg.d_edge_in),
                     generator=torch.Generator().manual_seed(2))
    _both(cuda, graphcast.loss_edges, p, cfg, nf, ef, es, ed, nf, 256)


@pytest.mark.parametrize("chunked", [False, True])
def test_equiformer_cuda_equals_cpu(cuda, chunked):
    cfg = dataclasses.replace(get_arch("equiformer-v2").smoke_config,
                              remat=True)
    p = equiformer.init_equiformer(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    nf, pos, es, ed = _inputs(128, 1024, cfg.d_feat)
    if chunked:
        es, ed = es.view(8, 128), ed.view(8, 128)
    target = torch.zeros((128, cfg.n_out))
    _both(cuda, equiformer.loss_edges, p, cfg, nf, pos, es, ed, target, 128)


def test_neighbor_sampler_ids_bitwise(cuda):
    g = rmat_graph(4096, 65_536, seed=0)
    seeds = prng.randint(prng.PRNGKey(2), (1024,), 0, g.n)
    host = neighbor_sampler(prng.PRNGKey(3), g.dst_offsets, g.in_src, seeds,
                            25)
    card = neighbor_sampler(prng.PRNGKey(3), g.dst_offsets.to(cuda),
                            g.in_src.to(cuda), seeds.to(cuda), 25)
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), host)
    hops = [sample_blocks(prng.PRNGKey(4), g.dst_offsets.to(d),
                          g.in_src.to(d), seeds.to(d), (15, 10))
            for d in (cuda, "cpu")]
    for (fc, nc), (fh, nh) in zip(*hops):
        assert torch.equal(fc.cpu(), fh) and torch.equal(nc.cpu(), nh)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_cuda_equals_cpu(cuda, mode):
    g = torch.Generator().manual_seed(5)
    table = torch.randn((500, 8), generator=g)
    idx = torch.randint(0, 501, (64, 6), generator=g)
    offsets = torch.sort(torch.randint(0, 384, (30,), generator=g)).values
    for args in ((idx,), (idx.reshape(-1), offsets)):
        _close(embedding_bag(table.to(cuda), *(a.to(cuda) for a in args),
                             mode=mode),
               embedding_bag(table, *args, mode=mode))


def test_meshed_graphcast_and_aggregate_on_the_card(cuda):
    cfg = dataclasses.replace(get_arch("graphcast").smoke_config,
                              node_axes=("data",), remat=True,
                              remat_group=2)
    p = graphcast.init_graphcast(torch.Generator(device=cuda).manual_seed(0),
                                 cfg, device=cuda)
    nf, _, es, ed = (x.to(cuda) for x in _inputs(64, 512, cfg.n_vars))
    ef = torch.randn((512, cfg.d_edge_in), device=cuda)
    mesh = Mesh([[cuda] * 2] * 2, ("data", "model"))
    ef_p, es_p, ed_p = graphcast.partition_edges(es, ed, ef, 64, 2, 2)
    _close(graphcast.forward_edges_dst_partitioned(
        p, cfg, nf, ef_p, es_p, ed_p, 64, mesh=mesh),
        graphcast.forward_edges(p, cfg, nf, ef, es, ed, 64))
    l1, g1 = value_and_grad(graphcast.loss_edges, p, cfg, nf, ef, es, ed,
                            nf, 64)
    l2, g2 = value_and_grad(graphcast.loss_edges_dst_partitioned, p, cfg,
                            nf, ef_p, es_p, ed_p, nf, 64, mesh=mesh)
    _close(l2, l1)
    _close_trees(g2, g1)
    h = torch.randn((64, 16), device=cuda)
    ss, ds, nb = partition_edges_by_dst(es.cpu().numpy(), ed.cpu().numpy(),
                                        64, 4)
    for op in ("sum", "mean", "max"):
        got = mpnn.sharded_aggregate(mesh, h, torch.tanh,
                                     torch.from_numpy(ss),
                                     torch.from_numpy(ds), nb,
                                     axis_name=("data", "model"), op=op)
        assert got.device.type == "cuda"
        _close(got[:64], mpnn.aggregate(torch.tanh(h[es]), ed, 64, op))
