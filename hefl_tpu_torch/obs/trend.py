"""Bench-history trend table and regression gate.

Counterpart of `hefl_tpu.obs.trend`. It reads the committed BENCH artifacts,
renders one table row per tracked metric (points, best, latest, delta) and
fails when the latest point regresses past a declared tolerance against the
best earlier point.

  * A `TrendSpec` names one metric: a basename glob (the series' files), a
    dotted path into the JSON, a direction ("down": lower is better, "up":
    higher) and a fractional tolerance. Files sort numeric-aware
    (BENCH_r2 < BENCH_r10); a file where the path is missing or None gives
    no point.
  * A single-point series is a baseline: in the table, never a regression.
  * The gate compares the LATEST point with the BEST earlier one.
  * `--extra FILE` appends artifacts after the committed history (matched
    to a series by basename).

`SPECS` name the port's artifacts only (BENCH_TORCH.json and
BENCH_TORCH_r*.json, BENCH_TORCH_LOAD*.json, BENCH_TORCH_INFER*.json,
BENCH_TORCH_DCN*.json, the files `hefl_tpu_torch.bench`,
`hefl_tpu_torch.fl.load`, `hefl_tpu_torch.bench_inference` and
`hefl_tpu_torch.fl.hierarchy` write): a card's numbers are never gated
against the TPU-era history the JAX package's specs read. A pattern may
list several globs separated by "|".

    python -m hefl_tpu_torch.obs.trend [--root DIR] [--out TREND.md]
        [--extra FILE ...] [--quiet]

Exit 0 clean, 1 on any regression, 2 when nothing could be read (a gate
that passes on an empty history is not a gate).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import glob as globlib
import json
import os
import re
from typing import Any, Iterable


@dataclasses.dataclass(frozen=True)
class TrendSpec:
    """One tracked metric: where its points live and what 'worse' means."""

    metric: str       # table name, e.g. "load.folds_per_s"
    pattern: str      # basename glob(s) of the series' artifact files, "|"-separated
    path: str         # dotted path into the JSON
    direction: str    # "down" (lower better) | "up" (higher better)
    tolerance: float  # allowed fractional regression vs the best earlier point


SPECS: tuple[TrendSpec, ...] = (
    TrendSpec("pipeline.wallclock_s", "BENCH_TORCH.json|BENCH_TORCH_r*.json",
              "value", "down", 0.25),
    TrendSpec("load.folds_per_s", "BENCH_TORCH_LOAD*.json",
              "bench_load.runs.commit_grouped.folds_per_s", "up", 0.30),
    TrendSpec("load.fsync_ratio", "BENCH_TORCH_LOAD*.json",
              "bench_load.group_commit.fsync_ratio", "down", 0.50),
    TrendSpec("load.ef_bytes_ratio", "BENCH_TORCH_LOAD*.json",
              "bench_load.ef_packing.bytes_ratio_b4_vs_b8", "down", 0.10),
    TrendSpec("load.commit_p95_sweep_max_s", "BENCH_TORCH_LOAD*.json",
              "bench_load.commit_latency_sweep", "down", 0.25),
    TrendSpec("infer.bsgs_batched_qps", "BENCH_TORCH_INFER*.json",
              "batched_vs_single.batched_qps", "up", 0.30),
    TrendSpec("infer.bsgs_hoisted_qps", "BENCH_TORCH_INFER*.json",
              "hoisted.hoisted_qps", "up", 0.30),
    TrendSpec("infer.mlp_ladder_qps", "BENCH_TORCH_INFER*.json",
              "mlp_compare.ladder_qps", "up", 0.30),
    TrendSpec("infer.mlp_bsgs_qps", "BENCH_TORCH_INFER*.json",
              "mlp_compare.mlp_bsgs_qps", "up", 0.30),
    TrendSpec("dcn.bytes_ratio", "BENCH_TORCH_DCN*.json",
              "dcn_compare.bytes_ratio", "up", 0.10),
)

INTRO = ("The port's committed BENCH_TORCH_*.json history, machine-read by "
         "`python -m hefl_tpu_torch.obs.trend`. `best` is the best EARLIER point; "
         "the gate fails when `latest` regresses past the declared tolerance. "
         "Single-point series are baselines.")


def _dig(obj: Any, path: str) -> Any:
    """Dotted-path lookup; None the moment a leg is missing."""
    cur = obj
    for leg in path.split("."):
        if not isinstance(cur, dict) or leg not in cur:
            return None
        cur = cur[leg]
    return cur


def _extract(spec: TrendSpec, doc: Any) -> float | None:
    """The spec's scalar from one artifact (None: no point here). A
    `commit_latency_sweep` path reduces to the WORST p95 over the sweep's
    (cohort, quorum) points."""
    v = _dig(doc, spec.path)
    if spec.path.endswith("commit_latency_sweep"):
        if not isinstance(v, dict):
            return None
        p95s = [p.get("commit_latency_s", {}).get("p95") for p in v.get("points", [])]
        p95s = [float(p) for p in p95s if isinstance(p, (int, float))]
        return max(p95s) if p95s else None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def _natural_key(name: str) -> tuple:
    """Numeric-aware sort key: BENCH_r2 < BENCH_r10."""
    return tuple(int(tok) if tok.isdigit() else tok
                 for tok in re.split(r"(\d+)", os.path.basename(name)))


def _load(path: str) -> Any | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


@dataclasses.dataclass
class TrendRow:
    """One metric's resolved series and its gate verdict."""

    metric: str
    direction: str
    tolerance: float
    points: list[tuple[str, float]]   # (artifact basename, value), ordered
    regressed: bool = False
    detail: str = ""

    @property
    def latest(self) -> float | None:
        return self.points[-1][1] if self.points else None

    @property
    def best(self) -> float | None:
        """Best over the EARLIER points (the regression baseline)."""
        if len(self.points) < 2:
            return None
        vals = [v for _, v in self.points[:-1]]
        return min(vals) if self.direction == "down" else max(vals)


def evaluate(root: str = ".", specs: Iterable[TrendSpec] = SPECS,
             extra: Iterable[str] = ()) -> list[TrendRow]:
    """Resolve every spec against `root`'s artifacts (and `extra` files
    appended as later points) -> gate-checked rows."""
    extra = list(extra)
    rows = []
    for spec in specs:
        globs = spec.pattern.split("|")
        files = sorted({p for g in globs for p in globlib.glob(os.path.join(root, g))},
                       key=_natural_key)
        files += [p for p in extra
                  if any(fnmatch.fnmatch(os.path.basename(p), g) for g in globs)]
        points: list[tuple[str, float]] = []
        for p in files:
            doc = _load(p)
            v = _extract(spec, doc) if doc is not None else None
            if v is not None:
                points.append((os.path.basename(p), v))
        row = TrendRow(spec.metric, spec.direction, spec.tolerance, points)
        best, latest = row.best, row.latest
        if best is not None and latest is not None:
            if spec.direction == "down":
                row.regressed = latest > best * (1.0 + spec.tolerance)
            else:
                row.regressed = latest < best * (1.0 - spec.tolerance)
            if row.regressed:
                row.detail = (f"latest {latest:g} vs best {best:g} breaches the "
                              f"{spec.tolerance:.0%} tolerance (direction: {spec.direction})")
        rows.append(row)
    return rows


def _delta_pct(row: TrendRow) -> str:
    if row.best in (None, 0) or row.latest is None:
        return "—"
    return f"{(row.latest - row.best) / abs(row.best):+.1%}"


def render_markdown(rows: list[TrendRow], intro: str = INTRO) -> str:
    """The trend table and the gate's verdict as markdown, `intro` under
    the heading."""
    lines = [
        "# Bench trend",
        "",
        intro,
        "",
        "| metric | dir | points | best | latest | Δ vs best | tol | status |",
        "|---|---|---:|---:|---:|---:|---:|---|",
    ]
    for r in rows:
        best = "—" if r.best is None else f"{r.best:g}"
        latest = "—" if r.latest is None else f"{r.latest:g}"
        status = "REGRESSED" if r.regressed else "baseline" if len(r.points) < 2 else "ok"
        lines.append(f"| {r.metric} | {r.direction} | {len(r.points)} | {best} | {latest} "
                     f"| {_delta_pct(r)} | {r.tolerance:.0%} | {status} |")
    lines.append("")
    reg = [r for r in rows if r.regressed]
    lines.append(f"**{len(reg)} regression(s).**" if reg else "No regressions past tolerance.")
    lines.append("")
    for r in rows:
        if r.points:
            lines.append(f"- `{r.metric}`: " + " → ".join(f"{v:g}" for _, v in r.points))
    lines.append("")
    return "\n".join(lines)


def _main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Trend-gate the port's BENCH_TORCH_*.json history.")
    ap.add_argument("--root", default=".", help="directory holding the BENCH artifacts")
    ap.add_argument("--out", default=None, help="write the trend table here (e.g. TREND.md)")
    ap.add_argument("--extra", action="append", default=[],
                    help="artifact appended AFTER the committed history (matched to its "
                         "series by basename; repeatable)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    rows = evaluate(args.root, extra=args.extra)
    md = render_markdown(rows)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
    if not args.quiet:
        print(md)
    n_points = sum(len(r.points) for r in rows)
    if n_points == 0:
        print("trend: no artifact produced a single point — nothing gated (exit 2)")
        return 2
    reg = [r for r in rows if r.regressed]
    for r in reg:
        print(f"trend REGRESSION: {r.metric}: {r.detail}")
    print(f"trend: {len(rows)} metrics, {n_points} points, {len(reg)} regression(s)"
          + (f" -> {args.out}" if args.out else ""))
    return 1 if reg else 0


if __name__ == "__main__":
    raise SystemExit(_main())
