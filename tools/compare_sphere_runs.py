"""Markdown tables that set the port's sphere-head runs beside the JAX
package's records, kimg by kimg (docs/torch_training.md).

    python3 tools/compare_sphere_runs.py

Reads docs/sphere_run_stats.jsonl and docs/torch_sphere_run_stats.jsonl (the
40-kimg runs: loss_d, loss_g, real_signs, ada_p at TRAINING.md:33-38's kimg
rows), then
docs/sphere_run2_metric_{fid,kid}.jsonl with docs/sphere_run2_stats.jsonl and
their torch_ counterparts (the resume to 120 kimg: FID, KID and the stats row
at each snapshot). Numbers are printed as recorded; nothing is computed but
the lookup of the nearest stats row at or before a snapshot.
"""

from __future__ import annotations

import json
import os

ROWS = (0.8, 13.6, 31.2, 40.0)  # the kimg rows of TRAINING.md:33-38
DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")


def read(name: str) -> list:
    path = os.path.join(DOCS, name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def at(rows: list, kimg: float):
    """The last row at or before kimg (within 1e-6), or None."""
    best = None
    for r in rows:
        if r["kimg"] <= kimg + 1e-6:
            best = r
    return best


def fmt(x, digits=3):
    return "—" if x is None else f"{x:.{digits}g}"


def main() -> None:
    jax1, port1 = read("sphere_run_stats.jsonl"), read("torch_sphere_run_stats.jsonl")
    keys = ("loss_d", "loss_g", "real_signs", "ada_p")
    print("| kimg | " + " | ".join(f"{k} JAX | {k} port" for k in keys) + " |")
    print("|---" * (1 + 2 * len(keys)) + "|")
    for k in ROWS:
        j, p = at(jax1, k), at(port1, k)
        print(f"| {k:g} | " + " | ".join(
            f"{fmt(j and j.get(n))} | {fmt(p and p.get(n))}" for n in keys) + " |")

    jstats, pstats = read("sphere_run2_stats.jsonl"), read("torch_sphere_run2_stats.jsonl")
    jm = {n: {r["kimg"]: r["results"][n] for r in read(f"sphere_run2_metric_{n}.jsonl")}
          for n in ("fid", "kid")}
    pm = {n: {r["kimg"]: r["results"][n] for r in read(f"torch_sphere_run2_metric_{n}.jsonl")}
          for n in ("fid", "kid")}
    print()
    print("| kimg | fid JAX | fid port | kid JAX | kid port | ada_p JAX | ada_p port | "
          "loss_d JAX | loss_d port | real_signs JAX | real_signs port |")
    print("|---" * 11 + "|")
    for k in sorted(set(jm["fid"]) | set(pm["fid"])):
        j, p = at(jstats, k), at(pstats, k)
        print(f"| {k:g} | {fmt(jm['fid'].get(k))} | {fmt(pm['fid'].get(k))} | "
              f"{fmt(jm['kid'].get(k))} | {fmt(pm['kid'].get(k))} | "
              f"{fmt(j and j['ada_p'])} | {fmt(p and p['ada_p'])} | "
              f"{fmt(j and j['loss_d'])} | {fmt(p and p['loss_d'])} | "
              f"{fmt(j and j['real_signs'])} | {fmt(p and p['real_signs'])} |")


if __name__ == "__main__":
    main()
