"""Markdown tables that set the port's sphere-head runs, or its flagship run
B, beside the JAX package's records, kimg by kimg (docs/torch_training.md).

    python3 tools/compare_sphere_runs.py [--run sphere|flagship]

Reads docs/sphere_run_stats.jsonl and docs/torch_sphere_run_stats.jsonl (the
40-kimg runs: loss_d, loss_g, real_signs, ada_p at TRAINING.md:33-38's kimg
rows), then
docs/sphere_run2_metric_{fid,kid}.jsonl with docs/sphere_run2_stats.jsonl and
their torch_ counterparts (the resume to 120 kimg: FID, KID and the stats row
at each snapshot). Numbers are printed as recorded; nothing is computed but
the lookup of the nearest stats row at or before a snapshot.

`--run flagship` reads docs/flagship_runB_{stats,metric_fid}.jsonl and their
torch_ counterparts (TRAINING.md:155-180): FID at each snapshot, the stats
row at or before 0.4, 4, 8, 12, 16 and 20 kimg, the largest |logit| of each
run (over the rows' interval means), and the grid std at 4, 14 and 18 kimg
(and at any other kimg with a grid in docs/img): the JAX run's as
TRAINING.md records it (its PNGs are not in the repo but for 16 kimg), and
computed from the PNGs that are (grid_std: TRAINING.md's measure, the
per-channel std that shows a mean-colour collapse, the samples' spread).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np

ROWS = (0.8, 13.6, 31.2, 40.0)  # the kimg rows of TRAINING.md:33-38
FLAGSHIP_STATS = (0.4, 4.0, 8.0, 12.0, 16.0, 20.0)
FLAGSHIP_FID = (4.0, 8.0, 12.0, 16.0, 20.0)
FLAGSHIP_GRIDS = (4, 14, 18)
JAX_GRID_STD = {4: 19.8, 14: 26.7, 18: 13.4}  # TRAINING.md:165, 174 (run B)
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


def grid_std(path: str) -> list:
    """[std of all the grid's uint8 values, the mean over R, G and B of each
    channel's std over the grid's pixels, the mean over pixels of the std
    across its 4x4 tiles]. The first is TRAINING.md's "grid std": it mixes the
    channels, so a grid of one flat colour reads as the spread of that
    colour's R, G and B (17-29 for the flagship grids). The second reads such
    a mean-colour collapse as ~0; the third, one mode in every tile as ~0."""
    import PIL.Image

    a = np.asarray(PIL.Image.open(path).convert("RGB"), np.float64)
    h, w = a.shape[0] // 4, a.shape[1] // 4
    tiles = a[:4 * h, :4 * w].reshape(4, h, 4, w, 3).transpose(0, 2, 1, 3, 4).reshape(16, h, w, 3)
    return [float(a.std()), float(a.reshape(-1, 3).std(0).mean()), float(tiles.std(0).mean())]


def grids(prefix: str) -> dict:
    """{kimg: path} of docs/img/<prefix>_fakes_<k>kimg.png."""
    found = {}
    for path in glob.glob(os.path.join(DOCS, "img", f"{prefix}_fakes_*kimg.png")):
        m = re.fullmatch(re.escape(prefix) + r"_fakes_(\d+)kimg\.png", os.path.basename(path))
        if m:
            found[int(m.group(1))] = path
    return found


def flagship() -> None:
    jax, port = read("flagship_runB_stats.jsonl"), read("torch_flagship_runB_stats.jsonl")
    jf = {r["kimg"]: r["results"]["fid"] for r in read("flagship_runB_metric_fid.jsonl")}
    pf = {r["kimg"]: r["results"]["fid"] for r in read("torch_flagship_runB_metric_fid.jsonl")}
    print("| kimg | FID JAX | FID port |")
    print("|---|---|---|")
    for k in sorted(set(FLAGSHIP_FID) | set(jf) | set(pf)):
        print(f"| {k:g} | {fmt(jf.get(k), 4)} | {fmt(pf.get(k), 4)} |")

    keys = ("real_logits", "fake_logits", "loss_d", "real_signs", "ada_p")
    print()
    print("| kimg | " + " | ".join(f"{k} JAX | {k} port" for k in keys) + " |")
    print("|---" * (1 + 2 * len(keys)) + "|")
    for k in FLAGSHIP_STATS:
        j, p = at(jax, k), at(port, k)
        print(f"| {k:g} | " + " | ".join(
            f"{fmt(j and j.get(n))} | {fmt(p and p.get(n))}" for n in keys) + " |")

    print()
    print("| run | largest \\|logit\\| | at kimg | real_logits | fake_logits |")
    print("|---|---|---|---|---|")
    for name, rows in (("JAX", jax), ("port", port)):
        if not rows:
            print(f"| {name} | — | — | — | — |")
            continue
        top = max(rows, key=lambda r: max(abs(r["real_logits"]), abs(r["fake_logits"])))
        big = max(abs(top["real_logits"]), abs(top["fake_logits"]))
        print(f"| {name} | {fmt(big)} | {top['kimg']:g} | {fmt(top['real_logits'])} | "
              f"{fmt(top['fake_logits'])} |")

    jg, pg = grids("flagship_runB"), grids("torch_flagship_runB")
    print()
    cols = ("grid std", "channel std", "tile spread")
    print("| kimg | grid std JAX (TRAINING.md) | "
          + " | ".join(f"{c} {r}" for r in ("JAX (PNG)", "port") for c in cols) + " |")
    print("|---" * 8 + "|")
    for k in sorted(set(FLAGSHIP_GRIDS) | set(jg) | set(pg)):
        j, p = (grid_std(g[k]) if k in g else [None] * 3 for g in (jg, pg))
        print(f"| {k} | {fmt(JAX_GRID_STD.get(k))} | " + " | ".join(fmt(x) for x in j + p) + " |")


def sphere() -> None:
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", choices=["sphere", "flagship"], default="sphere")
    args = ap.parse_args(argv)
    flagship() if args.run == "flagship" else sphere()


if __name__ == "__main__":
    main()
