"""The training runtime on the card, held to the host and to itself.

- a checkpoint restored after a fault puts every leaf back on ``cuda`` in
  the live state's dtype (bf16 params, f32 moments) and AdamW's ``step``
  where the live one is;
- a smoke-size LM run restored from a checkpoint replays to the
  uninterrupted run's final state bit for bit, on Zipf tokens whose
  repeated ids make ``index_add_``'s atomics order-dependent;
- the embedding gradient (``GatherRows``, `stable_segment_sum`) has the
  same bits on every run and the host's bits;
- int8 compression with error feedback: cuda == cpu bitwise;
- ``reshard_tree`` on a 2x2 mesh of the one card: every tile on the card
  with its block, gathered back bit for bit.

Every test needs a CUDA device and skips without one; the file imports
neither JAX nor the JAX package:
``python -m pytest -q -m cuda tests/test_torch_train_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models.common import GatherRows  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ElasticPlan, LoopConfig, TrainLoop, compress_with_feedback,
    gather_tree, init_error_feedback, reshard_tree,
)
from repro_torch.sparse.segment import stable_segment_sum  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _faults(at: int, n: int):
    left = {"n": n}

    def inject(step, retries):
        if step == at and left["n"] > 0:
            left["n"] -= 1
            return True
        return False

    return inject


def test_restored_leaves_land_on_cuda_in_their_dtypes(cuda, tmp_path):
    seen = []

    def step_fn(s, b):
        seen.append({k: (v.dtype, v.device.type) for k, v in s.items()})
        return ({"p": (s["p"].float() * 0.5 + b).to(torch.bfloat16),
                 "mu": s["mu"] + b, "step": s["step"] + 1},
                {"loss": s["p"].float().sum()})

    def init_fn():
        return {"p": torch.linspace(-1, 1, 9, device=cuda).to(torch.bfloat16),
                "mu": torch.zeros(9, device=cuda),
                "step": torch.zeros((), dtype=torch.int32)}

    loop = TrainLoop(LoopConfig(total_steps=5, checkpoint_dir=str(tmp_path),
                                save_every=2, max_retries=1),
                     step_fn, lambda step: 0.125, init_fn,
                     inject_fault=_faults(3, 2))
    final = loop.run()
    assert loop.recoveries == 1
    want = {"p": (torch.bfloat16, "cuda"), "mu": (torch.float32, "cuda"),
            "step": (torch.int32, "cpu")}
    assert seen and all(s == want for s in seen)
    clean = TrainLoop(LoopConfig(total_steps=5,
                                 checkpoint_dir=str(tmp_path / "clean"),
                                 save_every=2), step_fn, lambda step: 0.125,
                      init_fn).run()
    for k in want:
        assert torch.equal(final[k], clean[k]), k


def _loop(tmp, *, inject=None):
    # head dim 64 in bf16: the tensor-core kernel's training shape
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").smoke_config,
                              d_model=256, n_heads=4, n_kv_heads=4,
                              d_ff=512, vocab=8192, dtype="bfloat16")
    return train.lm_loop(cfg, steps=6, batch=4, seq_len=512,
                         checkpoint_dir=str(tmp), save_every=3, seed=3,
                         device="cuda", inject_fault=inject)


def test_restore_and_replay_is_bitwise_on_the_card(cuda, tmp_path):
    a = _loop(tmp_path / "a")
    state_a = a.run()
    b = _loop(tmp_path / "b", inject=_faults(4, 3))
    state_b = b.run()
    assert b.recoveries == 1 and b.history[4].restored
    for path, leaf in tree_leaves(state_b):
        want = _at(state_a, path)
        assert leaf.device == want.device and leaf.dtype == want.dtype
        assert torch.equal(leaf, want), path
    assert [float(r.metrics["loss"]) for r in b.history] == \
        [float(r.metrics["loss"]) for r in a.history]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("vocab,rows,dim", [(8192, 2048, 64),
                                            (151_936, 16_384, 1024)])
def test_embedding_gradient_is_deterministic(cuda, dtype, vocab, rows, dim):
    """Zipf ids (id 1 about 9% of them): five backward passes of the
    gather give the same bits, the host's bits, and the float64 sum
    rounded once (within one step of the dtype)."""
    toks, _ = TokenPipeline(vocab=vocab, batch=rows // 512,
                            seq_len=512).batch_at(0)
    ids = torch.from_numpy(toks).reshape(-1).long().to(cuda)
    g = torch.Generator(device=cuda).manual_seed(rows)
    table = torch.randn(vocab, dim, generator=g, device=cuda).to(dtype)
    dout = torch.randn(rows, dim, generator=g, device=cuda).to(dtype)
    grads = []
    for _ in range(5):
        t = table.clone().requires_grad_()
        GatherRows.apply(t, ids).backward(dout)
        grads.append(t.grad)
    for other in grads[1:]:
        assert torch.equal(other, grads[0])
    host = stable_segment_sum(dout.cpu(), ids.cpu(), vocab)
    assert torch.equal(grads[0].cpu(), host)
    # float32 sums (at most count * 2**-24 * sum |x| off), rounded once
    hid, hout = ids.cpu(), dout.cpu().double()
    exact = torch.zeros(vocab, dim, dtype=torch.float64).index_add_(
        0, hid, hout)
    absum = torch.zeros(vocab, dim, dtype=torch.float64).index_add_(
        0, hid, hout.abs())
    count = torch.bincount(hid, minlength=vocab).double()[:, None]
    step = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -23
    err = (grads[0].cpu().double() - exact).abs()
    assert bool((err <= step * exact.abs() + count * 2.0 ** -24 * absum
                 ).all())


def test_compression_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(2)
    shapes = {"embed": (4096, 64), "w": (3, 64, 96), "b": (7,),
              "z": (5, 5)}

    def draw(scale):
        out = {k: torch.from_numpy((rng.standard_normal(s) * scale
                                    ).astype(np.float32))
               for k, s in shapes.items()}
        out["z"] = torch.zeros(shapes["z"])
        return out

    g0 = draw(1.0)
    ef_c = init_error_feedback({k: v.to(cuda) for k, v in g0.items()})
    ef_h = init_error_feedback(g0)
    for i in range(20):
        g = draw(10.0 ** (i % 5 - 3))
        g["embed"] = g["embed"].to(torch.bfloat16)
        qc, ef_c = compress_with_feedback({k: v.to(cuda) for k, v in
                                           g.items()}, ef_c)
        qh, ef_h = compress_with_feedback(g, ef_h)
        for k in shapes:
            assert torch.equal(qc[k][0].cpu(), qh[k][0]), (i, k)
            assert torch.equal(qc[k][1].cpu().view(torch.int32),
                               qh[k][1].view(torch.int32)), (i, k)
            assert torch.equal(ef_c["residual"][k].cpu().view(torch.int32),
                               ef_h["residual"][k].view(torch.int32)), (i, k)


def test_reshard_on_a_2x2_mesh_of_the_card(cuda):
    mesh = Mesh([["cuda"] * 2] * 2, ("data", "model"))
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"embed": torch.randn(1024, 32, generator=g,
                                 device=cuda).to(torch.bfloat16),
            "layers": {"w": torch.randn(2, 32, 64, generator=g,
                                        device=cuda)},
            "step": torch.tensor(7, dtype=torch.int32)}

    def spec(path):
        return ("model",) if path == ("embed",) else ()

    out = reshard_tree(tree, ElasticPlan(mesh, spec))
    for (i, j), tile in np.ndenumerate(out["embed"].tiles):
        assert tile.device == mesh.devices[i, j]
        assert torch.equal(tile, tree["embed"][512 * j:512 * j + 512])
    for tile in out["layers"]["w"].tiles.reshape(-1):
        assert tile.device.type == "cuda"
        assert tile.data_ptr() != tree["layers"]["w"].data_ptr()
    back = gather_tree(out)
    assert torch.equal(back["embed"], tree["embed"])
    assert torch.equal(back["layers"]["w"], tree["layers"]["w"])
    assert back["step"].device.type == "cuda" and int(back["step"]) == 7
