"""
Regenerate the data tables in benchmarks/RESULTS.md from the committed
results_*.json files.

Why: round-3's RESULTS.md was hand-kept and drifted from the data it
described (flat_base_spike seed 101 was prose-reported as an honest
non-convergence while the JSON recorded converged=true above the KL gate
— VERDICT round 3, "what's weak" #2).  Tables are now generated: prose
lives in RESULTS.md between ``<!-- TABLE:name -->`` / ``<!-- /TABLE:name
-->`` marker pairs and the blocks inside the markers are owned by this
script.  Any ``converged`` count that includes a run whose accuracy
metric exceeds the 0.05 gate is flagged with a dagger right in the cell,
so a gate-failing pass can never be presented as a clean one.

Usage:
    python benchmarks/render_results.py            # rewrite RESULTS.md
    python benchmarks/render_results.py --check    # exit 1 on drift
"""

import argparse
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KL_GATE = 0.05

# fixture display names (reference provenance: tests/model_generator.py)
_FIXTURE_LABEL = {
    "loggaussian_d4": "loggaussian (d=4, 2 log-scale dims)",
    "curved_degeneracy_inf":
        "curved degeneracy + −inf floor (**vs reference head-to-head**)",
    "ring": "ring",
    "himmelblau": "Himmelblau (4 modes)",
    "rosenbrock": "Rosenbrock",
    "spike": "spike (broad mode + near-equal spike, d=2)",
    "flat_base_spike":
        "flat_base_spike (σ=0.01 spike on a 1e-4 flat base, d=1)",
}


def _load(name):
    path = os.path.join(HERE, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _fmt(x, sig=2):
    """Short significant-figure float format."""
    if x is None:
        return "-"
    if x == 0:
        return "0"
    ax = abs(x)
    if 0.001 <= ax < 10000:
        from decimal import Decimal
        q = -int(np.floor(np.log10(ax))) + sig - 1
        return f"{round(x, q):g}"
    return f"{x:.{sig - 1}e}"


import numpy as np  # noqa: E402  (after _fmt's doc; used throughout)


def _conv_cell(rows, metric_key, gate=KL_GATE):
    """'n/N' converged cell; daggers any converged run above the gate."""
    n = sum(bool(r.get("converged")) for r in rows)
    cell = f"{n}/{len(rows)}"
    bad = [r for r in rows
           if r.get("converged") and (r.get(metric_key) or 0) > gate]
    if bad:
        cell += "†"  # †: converged above the accuracy gate
    return cell


def _metric_cells(rows, metric_key, gate=KL_GATE):
    out = []
    for r in rows:
        s = _fmt(r.get(metric_key))
        if r.get("converged") and (r.get(metric_key) or 0) > gate:
            s += "†"
        out.append(s)
    return ", ".join(out)


def table_parity(rows=None):
    if rows is None:
        data = _load("results_parity.json")
        rows = data["rows"] if data else []
    lines = ["| d | engine | evals to stop (per seed) | "
             "final KL (per seed) | converged |",
             "|---|--------|--------------------------|"
             "----------------------|-----------|"]
    dims = sorted({r["d"] for r in rows})
    for d in dims:
        for engine in ("gpry_tpu", "reference"):
            sel = [r for r in rows
                   if r["d"] == d and r["engine"] == engine]
            if not sel:
                continue
            sel.sort(key=lambda r: r["seed"])
            name = f"**{engine}**" if engine == "gpry_tpu" else engine
            lines.append(
                f"| {d} | {name} | "
                f"{', '.join(str(r['n_total']) for r in sel)} | "
                f"{_metric_cells(sel, 'kl_final')} | "
                f"{_conv_cell(sel, 'kl_final')} |")
    return lines


def table_nongaussian():
    data = _load("results_nongaussian.json")
    if not data:
        return ["(results_nongaussian.json missing)"]
    rows = [r for r in data["rows"] if "error" not in r]
    lines = ["| Fixture (seeds 100-102) | engine | evals to stop | "
             "SVM active? | moments-KL | converged |",
             "|---|---|---|---|---|---|"]
    seen = []
    for r in rows:
        key = r["fixture"]
        if key not in seen:
            seen.append(key)
    for fx in seen:
        for engine in sorted({r["engine"] for r in rows
                              if r["fixture"] == fx}):
            sel = sorted((r for r in rows if r["fixture"] == fx
                          and r["engine"] == engine),
                         key=lambda r: r["seed"])
            svm = [r.get("svm_active", r["n_finite"] < r["n_total"])
                   for r in sel]
            svm_cell = ("all" if all(svm) else
                        "none" if not any(svm) else
                        f"{sum(svm)} of {len(svm)}")
            if any("svm_active" not in r for r in sel):
                svm_cell += " (inferred)"
            label = _FIXTURE_LABEL.get(fx, fx)
            eng = "repo (NORA)" if engine.startswith("gpry_tpu") \
                else engine
            lines.append(
                f"| {label} | {eng} | "
                f"{', '.join(str(r['n_total']) for r in sel)} | "
                f"{svm_cell} | "
                f"{_metric_cells(sel, 'moments_kl_vs_truth')} | "
                f"{_conv_cell(sel, 'moments_kl_vs_truth')} |")
    return lines


def table_lcdm():
    data = _load("results_lcdm.json")
    if not data:
        return ["(results_lcdm.json missing)"]
    lines = ["| executor | converged | evals to stop | final KL | "
             "truth-phase wall (s) |",
             "|---|---|---|---|---|"]
    for s in data["summary"]:
        rows = [r for r in data["rows"]
                if r["executor"] == s["executor"]]
        rows.sort(key=lambda r: r["seed"])
        lines.append(
            f"| {s['executor']} | {_conv_cell(rows, 'kl_final')} | "
            f"{', '.join(str(r['n_total']) for r in rows)} | "
            f"{_metric_cells(rows, 'kl_final')} | "
            f"{', '.join(_fmt(r['truth_wall_s']) for r in rows)} |")
    return lines


def table_evalreduction():
    data = _load("results_evalreduction.json")
    if not data:
        return ["(results_evalreduction.json missing)"]
    lines = ["| d | direct-NS log-density calls (KL) | "
             "runner truth evals (KL) | reduction |",
             "|---|----------------------------------|"
             "--------------------------|-----------|"]
    for r in data["rows"]:
        ns = r["direct_ns"]
        lines.append(
            f"| {r['d']} | {ns['n_calls']:,} ({_fmt(ns['kl'])}) | "
            f"{r['runner_evals_to_stop']} ({_fmt(r['runner_kl'])}) | "
            f"**{r['reduction_factor']:,.0f}×** |")
    return lines


def table_grid():
    lines = ["| d | runs | converged | evals to stop (median) | "
             "reference heuristic 3.5 d^2 | final KL (median) | KL gate |",
             "|---|------|-----------|-------------------------|"
             "------------------------------|-------------------|"
             "---------|"]
    for name in ("results_d4.json", "results_d8.json",
                 "results_d12.json"):
        data = _load(name)
        if not data:
            continue
        evals = data["evals_to_stop"]
        kls = data["kl_final"]
        med_kl = float(np.median(kls))
        gate = "<= 0.05" if med_kl <= KL_GATE else "**ABOVE 0.05**"
        lines.append(
            f"| {data['d']} | {data['n_runs']} | "
            f"{data['n_converged']}/{data['n_runs']} | "
            f"**{data['evals_to_stop_median']:g}** "
            f"(range {min(evals)}-{max(evals)}) | "
            f"{data.get('reference_heuristic_3.5d2', '-')} | "
            f"**{_fmt(med_kl)}** | {gate} |")
    return lines


def table_parity_d12():
    data = _load("results_parity_d12.json")
    return table_parity(data["rows"] if data else [])


def table_d12_zeta():
    data = _load("results_d12_zeta.json")
    if not data:
        return ["(results_d12_zeta.json missing)"]
    lines = ["| seed | zeta multiplier | converged | evals to stop | "
             "final KL |",
             "|------|-----------------|-----------|---------------|"
             "----------|"]
    for r in data["rows"]:
        if "error" in r:
            lines.append(f"| {r['seed']} | {r['zeta_mult']} | "
                         f"ERROR | - | {r['error']} |")
            continue
        kl = _fmt(r.get("kl_final"))
        if (r.get("kl_final") or 0) > KL_GATE:
            kl += "†"
        lines.append(
            f"| {r['seed']} | {r['zeta_mult']:g} | "
            f"{'yes' if r.get('converged') else 'no'} | "
            f"{r.get('n_total', '-')} | {kl} |")
    return lines


TABLES = {
    "parity": table_parity,
    "parity_d12": table_parity_d12,
    "nongaussian": table_nongaussian,
    "lcdm": table_lcdm,
    "evalreduction": table_evalreduction,
    "grid": table_grid,
    "d12_zeta": table_d12_zeta,
}

_MARKER = re.compile(
    r"(<!-- TABLE:(\w+) -->\n)(.*?)(<!-- /TABLE:\2 -->)", re.DOTALL)


def render(text):
    def _sub(m):
        name = m.group(2)
        if name not in TABLES:
            raise KeyError(f"RESULTS.md references unknown table {name!r}")
        body = "\n".join(TABLES[name]()) + "\n"
        return m.group(1) + body + m.group(4)

    out, n = _MARKER.subn(_sub, text)
    if n == 0:
        raise RuntimeError("no <!-- TABLE:name --> markers found")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if RESULTS.md tables drift from the "
                         "JSONs instead of rewriting")
    args = ap.parse_args(argv)
    path = os.path.join(HERE, "RESULTS.md")
    with open(path) as f:
        text = f.read()
    new = render(text)
    if args.check:
        if new != text:
            sys.stderr.write(
                "RESULTS.md tables drift from results_*.json — run "
                "python benchmarks/render_results.py\n")
        return 1 if new != text else 0
    if new != text:
        with open(path, "w") as f:
            f.write(new)
        print(f"rewrote {path}")
    else:
        print("RESULTS.md already up to date")
    return 0


if __name__ == "__main__":
    sys.exit(main())
