"""Quickstart: influence maximization with EfficientIMM in ~20 lines.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core import IMMConfig, imm
from repro_torch.device import resolve_device
from repro_torch.graphs import rmat_graph


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a power-law social graph (synthetic stand-in for a SNAP graph)
    graph = rmat_graph(n=2_000, m=16_000, seed=0)

    # EfficientIMM defaults: fused counting (C3), RRRset-partitioned
    # rebuild selection (C1+C5), adaptive representation (C4)
    result = imm(graph, IMMConfig(k=10, eps=0.5, model="IC",
                                  max_theta=4096), device=dev)
    seeds = [int(v) for v in result.seeds]

    print(f"graph: n={graph.n} m={graph.m}")
    print(f"seeds: {seeds}")
    print(f"estimated influence: {result.influence:.1f} nodes "
          f"({100 * result.covered_frac:.1f}% RRR coverage)")
    print(f"RRR sets sampled: {result.theta}  "
          f"(representation: {result.representation})")

    # the Ripples-style baseline is one flag away (paper comparison)
    baseline = imm(graph, IMMConfig(
        k=10, eps=0.5, model="IC", max_theta=4096,
        selection_method="decrement", adaptive_representation=False),
        device=dev)
    print(f"baseline influence (identical math): {baseline.influence:.1f}")
    return {"n": graph.n, "m": graph.m, "seeds": seeds,
            "influence": float(result.influence),
            "covered_frac": float(result.covered_frac),
            "theta": int(result.theta),
            "representation": result.representation,
            "baseline_seeds": [int(v) for v in baseline.seeds],
            "baseline_influence": float(baseline.influence),
            "baseline_theta": int(baseline.theta)}


if __name__ == "__main__":
    main()
