"""Private-inference serving benchmark: the BENCH_INFER artifact family.

Counterpart of the repository's root `bench_inference.py`, on the port. It
measures the steady-state serving cost of the scorers: the ladder
`LinearScorer` (the reference the BSGS plan is held to), `BsgsLinearScorer`
hoisted and unhoisted, batched against single queries, the ladder
`MlpScorer` against the composed `BsgsMlpScorer`. Each call is timed to
completion (`torch.cuda.synchronize()` on a card): `compile_s` is the first
call, the kernel build and warm-up included, then per-call latency
percentiles (p50/p95/p99) and QPS over `--reps` calls.

Rows and artifact blocks are the root bench's: `rows`, `batched_vs_single`,
`hoisted`, `mlp_compare`, `analysis_check` (the `check_inference`
certificates of both serving rings, run before any bench work) and
`he_backend`; plus `device`, the card's name and power limit. The gates of
the repository's perf smoke decide the exit code: every row's argmax right,
the ladder, bsgs, bsgs_hoisted, bsgs_unhoisted, mlp and mlp_bsgs plans
present, hoisted == unhoisted bitwise (parity shas) with strictly fewer
forward NTTs a score and at least 1.3x the QPS, batched at least 1.3x the
single QPS, mlp_bsgs fewer key-switches a score than the ladder MLP, the
composed MLP's parity shas equal, no analysis violation.

The unhoisted twin computes each baby step's key inner product in plain
PyTorch int64 (`ops._uncentered_products`, as the JAX twin does in XLA), not
in a kernel: on a card its eager launches, not the transforms hoisting
saves, set most of the `hoisted` speedup. The block says so in its `note`.

    python -m hefl_tpu_torch.bench_inference [--out BENCH_TORCH_INFER.json]
        [--reps 20] [--smoke] [--device cpu]

The geometry is chip_smoke.py's phases 4-5: linear N=4096, d=512, K=10;
MLP N=8192, L=5, d=64, H=16. `--smoke` shrinks the rings (N=256 and 512,
d=32, MLP d=16 H=4) for a run of the plain versions on the CPU.
"""

from __future__ import annotations

import hashlib
import json
import time

import numpy as np
import torch

HOIST_SPEEDUP_FLOOR = 1.3
BATCH_SPEEDUP_FLOOR = 1.3


def _measure(call, reps: int, device: torch.device):
    """-> (compile_s, latencies_s[reps], last output): each call blocked to
    completion, the first one (kernel build, warm-up) apart."""

    def timed():
        t0 = time.perf_counter()
        out = call()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0, out

    compile_s, out = timed()
    lats = []
    for _ in range(reps):
        dt, out = timed()
        lats.append(dt)
    return compile_s, np.asarray(lats), out


def _row(name, plan, batch, keyswitches, compile_s, lats, err, argmax_ok, ntts=None) -> dict:
    mean = float(np.mean(lats))
    row = {
        "row": name,
        "plan": plan,
        "batch": batch,
        "keyswitches_per_score": keyswitches,
        "compile_s": round(compile_s, 3),
        "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 3),
        "p95_ms": round(float(np.percentile(lats, 95)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 3),
        "warm_latency_ms": round(mean * 1e3, 3),
        "qps": round(batch / mean, 2),
        "scores_per_s": round(batch / mean, 2),
        "max_abs_err": err,
        "argmax_ok": argmax_ok,
    }
    if ntts is not None:
        row["forward_ntts_per_score"] = int(ntts)
    return row


def _parity_sha(out) -> str:
    """sha256 over the (c0, c1) residue bytes: equal shas, bitwise-equal
    ciphertexts."""
    h = hashlib.sha256()
    h.update(out.c0.cpu().contiguous().numpy().tobytes())
    h.update(out.c1.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _score_row(name, plan, batch, keyswitches, measured, got, want, ntts=None) -> dict:
    compile_s, lats, _ = measured
    return _row(name, plan, batch, keyswitches, compile_s, lats,
                float(np.max(np.abs(got - want))),
                bool(np.all(np.argmax(got, -1) == np.argmax(want, -1))), ntts)


def run(device, reps: int = 20, smoke: bool = False) -> dict:
    """Run every row on `device` -> the BENCH_INFER artifact (with `gates`,
    the failed gates, empty when all hold)."""
    from hefl_tpu_torch import device_record
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.analysis import check_inference
    from hefl_tpu_torch.ckks import encoding
    from hefl_tpu_torch.ckks.keys import CkksContext, gen_relin_key, keygen
    from hefl_tpu_torch.obs import metrics as obs_metrics

    device = torch.device(device)
    rows = []
    rng = np.random.default_rng(42)
    certified = []
    base_violations = obs_metrics.snapshot().get("analysis.violations", 0)

    # --- Linear: the ladder reference against the BSGS serving plan -------
    n_lin = 256 if smoke else 4096
    ctx = CkksContext.create(n=n_lin)
    certified.extend(c.summary() for c in check_inference(ctx).values())
    gen = torch.Generator().manual_seed(0)
    sk, pk = keygen(ctx, gen, device=device)
    gks = hei.gen_rotation_keys(ctx, sk, 1)
    slots = encoding.num_slots(ctx.ntt)
    # d = slots/4 leaves room for 4 queries a ciphertext in the batched row.
    d = 32 if smoke else slots // 4
    k = 10
    W = rng.normal(0, 0.3, (k, d))
    b = rng.normal(0, 0.2, k)
    want = lambda xs: np.asarray(xs) @ W.T + b  # noqa: E731
    x1 = rng.normal(0, 0.5, d)
    ct1 = hei.encrypt_features(ctx, pk, x1, gen)
    b_lin = 8 if smoke else 16

    ladder = hei.LinearScorer(ctx, W, b, gks, device=device)
    measured = _measure(lambda: ladder.score_batched(ct1), reps, device)
    got = hei.decrypt_score_matrix(ctx, sk, measured[2])
    rows.append(_score_row(f"linear N={n_lin} d={d} K={k}", "ladder", 1,
                           hei.ladder_keyswitches(slots, k), measured, got, want(x1)))

    plan = hei.bsgs_plan(slots, d, k)
    bsgs_gks = hei.gen_rotation_keys_for_steps(ctx, sk, 2, plan.rotation_steps_needed)
    bsgs = hei.BsgsLinearScorer(ctx, W, b, bsgs_gks, device=device)
    measured = _measure(lambda: bsgs.score(ct1), reps, device)
    got = hei.decrypt_class_scores(ctx, sk, measured[2], k)
    single = _score_row(f"bsgs N={n_lin} d={d} K={k}", "bsgs", 1, bsgs.plan.num_keyswitches,
                        measured, got, want(x1), ntts=bsgs.hoisted_ntts)
    rows.append(single)

    # Hoisted against unhoisted: the same baby-heavy plan with the baby
    # sweep's decomposition shared, and re-run per step; bitwise equal.
    hoist_baby = 16 if smoke else 64
    hoist_gks = hei.gen_rotation_keys_for_steps(
        ctx, sk, 3, hei.bsgs_plan(slots, d, k, hoist_baby).rotation_steps_needed)
    pair = {}
    for mode in ("hoisted", "unhoisted"):
        scorer = hei.BsgsLinearScorer(ctx, W, b, hoist_gks, baby=hoist_baby, rotation_mode=mode,
                                      device=device)
        measured = _measure(lambda: scorer.score(ct1), reps, device)
        got = hei.decrypt_class_scores(ctx, sk, measured[2], k)
        ntts = scorer.hoisted_ntts if mode == "hoisted" else scorer.unhoisted_ntts
        row = _score_row(f"bsgs_{mode} N={n_lin} d={d} K={k} b={hoist_baby}", f"bsgs_{mode}", 1,
                         scorer.plan.num_keyswitches, measured, got, want(x1), ntts=ntts)
        rows.append(row)
        pair[mode] = (row, measured[2])
    (h_row, out_h), (u_row, out_u) = pair["hoisted"], pair["unhoisted"]
    hoisted_cmp = {
        "plan": "bsgs",
        "baby": hoist_baby,
        "hoisted_qps": h_row["qps"],
        "unhoisted_qps": u_row["qps"],
        "speedup": round(h_row["qps"] / u_row["qps"], 3),
        "hoisted_ntts_per_score": h_row["forward_ntts_per_score"],
        "unhoisted_ntts_per_score": u_row["forward_ntts_per_score"],
        "parity_sha_hoisted": _parity_sha(out_h),
        "parity_sha_unhoisted": _parity_sha(out_u),
        "note": ("the unhoisted twin's per-step key inner product is plain PyTorch int64 "
                 "(ops._uncentered_products), not a kernel; the hoisted plan's is K6"),
    }
    hoisted_cmp["parity"] = hoisted_cmp["parity_sha_hoisted"] == hoisted_cmp["parity_sha_unhoisted"]

    # Batched serving: q queries a ciphertext and B_ct ciphertexts a call.
    q = max(1, slots // max(d, k))
    while slots % q:
        q -= 1
    b_ct = max(1, b_lin // q)
    n_queries = q * b_ct
    xq = rng.normal(0, 0.5, (b_ct, q, d))
    packed = hei.BsgsLinearScorer(ctx, W, b, bsgs_gks, queries_per_ct=q, device=device)
    ct_q = hei.encrypt_query_block(ctx, pk, xq, gen, q)
    measured = _measure(lambda: packed.score_many(ct_q), reps, device)
    got = hei.decrypt_class_scores(ctx, sk, measured[2], k, queries_per_ct=q)
    batched = _score_row(f"bsgs N={n_lin} d={d} K={k} q={q} B={n_queries}", "bsgs", n_queries,
                         round(packed.plan.num_keyswitches / q, 2), measured, got, want(xq))
    rows.append(batched)
    batched_vs_single = {
        "plan": "bsgs",
        "batch": n_queries,
        "queries_per_ct": q,
        "single_qps": single["qps"],
        "batched_qps": batched["qps"],
        "speedup": round(batched["qps"] / single["qps"], 3),
    }

    # --- Depth-2 MLP (square activation): ladder and composed BSGS --------
    n_mlp = 512 if smoke else 8192
    ctx2 = CkksContext.create(n=n_mlp, num_primes=5)
    certified.extend(c.summary() for c in check_inference(ctx2).values())
    gen2 = torch.Generator().manual_seed(10)
    sk2, pk2 = keygen(ctx2, gen2, device=device)
    gks2 = hei.gen_rotation_keys(ctx2, sk2, 11)
    rlk2 = gen_relin_key(ctx2, sk2, gen2)
    d2, hidden = (16, 4) if smoke else (64, 16)
    w1, b1 = rng.normal(0, 0.3, (hidden, d2)), rng.normal(0, 0.2, hidden)
    w2, b2 = rng.normal(0, 0.3, (k, hidden)), rng.normal(0, 0.2, k)
    mlp = hei.MlpScorer(ctx2, w1, b1, w2, b2, gks2, rlk2, device=device)
    sk_dec = hei.slice_secret_key(sk2, mlp.sub_ctx.num_primes)
    mlp_want = lambda xs: ((np.asarray(xs) @ w1.T + b1) ** 2) @ w2.T + b2  # noqa: E731
    mlp_ks = mlp.num_keyswitches

    xm = rng.normal(0, 0.4, d2)
    ctm = hei.encrypt_features(ctx2, pk2, xm, gen2)
    measured = _measure(lambda: mlp.score_batched(ctm), reps, device)
    got = hei.decrypt_score_matrix(mlp.sub_ctx, sk_dec, measured[2])
    rows.append(_score_row(f"mlp N={n_mlp} d={d2} H={hidden} K={k}", "mlp", 1, mlp_ks,
                           measured, got, mlp_want(xm)))
    b_mlp = 2 if smoke else 8
    xms = rng.normal(0, 0.4, (b_mlp, d2))
    ctms = hei.encrypt_features(ctx2, pk2, xms, gen2)
    measured = _measure(lambda: mlp.score_many(ctms), reps, device)
    got = hei.decrypt_score_matrix(mlp.sub_ctx, sk_dec, measured[2])
    ladder_mlp_row = _score_row(f"mlp N={n_mlp} d={d2} H={hidden} K={k} B={b_mlp}", "mlp",
                                b_mlp, mlp_ks, measured, got, mlp_want(xms))
    rows.append(ladder_mlp_row)

    plan1, plan2 = hei.bsgs_mlp_plans(encoding.num_slots(ctx2.ntt), d2, hidden, k)
    mgks1 = hei.gen_rotation_keys_for_steps(ctx2, sk2, 13, plan1.rotation_steps_needed)
    msub = hei.mlp_sub_context(ctx2, 2)
    mgks2 = hei.gen_rotation_keys_for_steps(msub, hei.slice_secret_key(sk2, msub.num_primes), 14,
                                            plan2.rotation_steps_needed)
    mlp_bsgs = hei.BsgsMlpScorer(ctx2, w1, b1, w2, b2, mgks1, rlk2, mgks2, device=device)
    measured = _measure(lambda: mlp_bsgs.score(ctm), reps, device)
    out_mb = measured[2]
    got = hei.decrypt_class_scores(mlp_bsgs.sub_ctx, sk_dec, out_mb, k)
    mlp_bsgs_row = _score_row(f"mlp_bsgs N={n_mlp} d={d2} H={hidden} K={k}", "mlp_bsgs", 1,
                              mlp_bsgs.num_keyswitches, measured, got, mlp_want(xm),
                              ntts=mlp_bsgs.hoisted_ntts)
    rows.append(mlp_bsgs_row)
    out_mbu = hei.BsgsMlpScorer(ctx2, w1, b1, w2, b2, mgks1, rlk2, mgks2,
                                rotation_mode="unhoisted", device=device).score(ctm)
    mlp_compare = {
        "plan": "mlp_bsgs",
        "ladder_qps": ladder_mlp_row["qps"] / ladder_mlp_row["batch"],
        "mlp_bsgs_qps": mlp_bsgs_row["qps"],
        "ladder_keyswitches_per_score": mlp_ks,
        "mlp_bsgs_keyswitches_per_score": mlp_bsgs.num_keyswitches,
        "hoisted_ntts_per_score": mlp_bsgs.hoisted_ntts,
        "unhoisted_ntts_per_score": mlp_bsgs.unhoisted_ntts,
        "parity_sha_hoisted": _parity_sha(out_mb),
        "parity_sha_unhoisted": _parity_sha(out_mbu),
    }
    mlp_compare["parity"] = mlp_compare["parity_sha_hoisted"] == mlp_compare["parity_sha_unhoisted"]

    violations = int(obs_metrics.snapshot().get("analysis.violations", 0) - base_violations)
    artifact = {
        "artifact": "BENCH_INFER",
        "device": device_record(device),
        "backend": device.type,
        "smoke": smoke,
        "reps": reps,
        "rows": rows,
        "batched_vs_single": batched_vs_single,
        "hoisted": hoisted_cmp,
        "mlp_compare": mlp_compare,
        "analysis_check": {"violations": violations, "certified": certified},
        "he_backend": {"requested": "auto", "backend": "cuda" if device.type == "cuda" else "plain",
                       "auto_timings_ms": None, "auto_persisted": False},
    }
    artifact["gates"] = gate_failures(artifact)
    return artifact


def gate_failures(art: dict) -> list[str]:
    """The repository's serving gates on one artifact -> the failed ones."""
    fail = []
    rows = art.get("rows") or []
    if len(rows) < 5:
        fail.append(f"expected >= 5 serving rows, got {len(rows)}")
    for r in rows:
        for field in ("plan", "batch", "keyswitches_per_score", "p50_ms", "p95_ms", "p99_ms",
                      "qps", "max_abs_err", "argmax_ok"):
            if r.get(field) is None:
                fail.append(f"row {r.get('row')}: missing {field}")
        if r.get("argmax_ok") is not True:
            fail.append(f"row {r.get('row')}: argmax_ok false")
    plans = {r.get("plan") for r in rows}
    need = {"ladder", "bsgs", "mlp", "bsgs_hoisted", "bsgs_unhoisted", "mlp_bsgs"}
    if not need <= plans:
        fail.append(f"plans {sorted(need - plans)} missing")
    hoist = art.get("hoisted") or {}
    if hoist.get("parity") is not True:
        fail.append("hoisted/unhoisted BSGS parity shas differ")
    hn, un = hoist.get("hoisted_ntts_per_score"), hoist.get("unhoisted_ntts_per_score")
    if not (isinstance(hn, int) and isinstance(un, int) and hn < un):
        fail.append(f"hoisted forward NTTs/score ({hn}) not strictly below unhoisted ({un})")
    if not (hoist.get("speedup") or 0) >= HOIST_SPEEDUP_FLOOR:
        fail.append(f"hoisted-vs-unhoisted QPS speedup {hoist.get('speedup')}x below "
                    f"{HOIST_SPEEDUP_FLOOR}x")
    mcmp = art.get("mlp_compare") or {}
    if mcmp.get("parity") is not True:
        fail.append("mlp_bsgs hoisted/unhoisted parity shas differ")
    lks, bks = mcmp.get("ladder_keyswitches_per_score"), mcmp.get("mlp_bsgs_keyswitches_per_score")
    if not (isinstance(lks, (int, float)) and isinstance(bks, (int, float)) and bks < lks):
        fail.append(f"mlp_bsgs keyswitches/score ({bks}) not below the ladder MLP's ({lks})")
    check = art.get("analysis_check") or {}
    if check.get("violations") != 0:
        fail.append(f"analysis.violations = {check.get('violations')}")
    certs = check.get("certified") or []
    if len(certs) < 4 or not all("CERTIFIED" in c for c in certs):
        fail.append(f"expected 4 CERTIFIED summaries, got {len(certs)}")
    if not any("keyswitch gadget" in c for c in certs):
        fail.append("no keyswitch gadget certificate")
    if not isinstance(art.get("he_backend"), dict):
        fail.append("missing he_backend record")
    if not ((art.get("batched_vs_single") or {}).get("speedup") or 0) >= BATCH_SPEEDUP_FLOOR:
        fail.append(f"batched-vs-single speedup {art.get('batched_vs_single', {}).get('speedup')}x "
                    f"below {BATCH_SPEEDUP_FLOOR}x")
    return fail


def _main(argv: list[str] | None = None) -> int:
    import argparse

    from hefl_tpu_torch import resolve_device

    ap = argparse.ArgumentParser(description="The port's private-inference serving bench.")
    ap.add_argument("--out", default="BENCH_TORCH_INFER.json")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="shrunken rings (N=256 and 512)")
    ap.add_argument("--device", default=None, help="where the scorers run (default: cuda)")
    args = ap.parse_args(argv)
    art = run(resolve_device(args.device), reps=args.reps, smoke=args.smoke)
    dev = art["device"]
    print(f"# Private-inference serving bench ({dev['kind']}, {dev['power_limit']}, "
          f"reps={art['reps']})")
    print()
    print("| config | plan | B | keyswitches/score | compile (s) | p50 (ms) | p95 (ms) | "
          "p99 (ms) | QPS | max |err| | argmax ok |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in art["rows"]:
        print(f"| {r['row']} | {r['plan']} | {r['batch']} | {r['keyswitches_per_score']} "
              f"| {r['compile_s']} | {r['p50_ms']} | {r['p95_ms']} | {r['p99_ms']} "
              f"| {r['qps']} | {r['max_abs_err']:.2e} | {r['argmax_ok']} |")
    print()
    bvs, hc, mc = art["batched_vs_single"], art["hoisted"], art["mlp_compare"]
    print(f"batched-vs-single ({bvs['plan']}, B={bvs['batch']}): {bvs['speedup']}x QPS")
    print(f"hoisted-vs-unhoisted (bsgs): {hc['speedup']}x QPS, {hc['hoisted_ntts_per_score']} "
          f"vs {hc['unhoisted_ntts_per_score']} forward NTTs/score, "
          f"parity={'OK' if hc['parity'] else 'BROKEN'}")
    print(f"mlp ladder-vs-bsgs: {mc['ladder_keyswitches_per_score']} vs "
          f"{mc['mlp_bsgs_keyswitches_per_score']} keyswitches/score, "
          f"parity={'OK' if mc['parity'] else 'BROKEN'}")
    for r in art["rows"] + [dict(row="analysis_check", **art["analysis_check"])]:
        print(json.dumps(r))
    with open(args.out, "w") as f:
        json.dump(art, f, indent=2)
    for g in art["gates"]:
        print(f"bench_inference GATE FAILED: {g}")
    print(f"artifact written to {args.out}")
    return 1 if art["gates"] else 0


if __name__ == "__main__":
    raise SystemExit(_main())
