"""Work the spawned ranks of `tests/test_torch_mesh_stream.py` run.

Each function runs on every rank of a `hefl_tpu_torch.parallel.launch.World`
(gloo on the CPU) and returns numpy values or plain records. No JAX here.
Rank 0 also runs the one-rank twin of what the world ran (no mesh, the
whole arrays) on the same inputs, in the same process, so the test holds
the mesh against the one-device code bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from hefl_tpu_torch import parallel
from hefl_tpu_torch.ckks import keys
from hefl_tpu_torch.ckks.packing import PackedSpec, PackSpec
from hefl_tpu_torch.data import RoundPrefetcher
from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
from hefl_tpu_torch.data.synthetic import make_dataset
from hefl_tpu_torch.experiment import deterministic_algorithms
from hefl_tpu_torch.fl import fedavg, secure, stream
from hefl_tpu_torch.fl.config import HheConfig, PackingConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.faults import FaultConfig
from hefl_tpu_torch.models import create_model

CFG = TrainConfig(epochs=1, batch_size=4, num_classes=10, augment=False, val_fraction=0.25,
                  client_fusion="vmap")

# A sampled cohort under a deadline, retries, tau = 1, stragglers, a
# duplicate, a transient loss and a NaN client; float CKKS uploads.
FLAT = (dict(cohort_size=2, quorum=0.5, deadline_s=1.0, max_retries=1, retry_jitter=0.5,
             staleness_rounds=1, seed=2),
        dict(seed=13, straggler_fraction=0.25, straggler_delay_s=3.0, arrival_delay_s=0.5,
             duplicate_clients=1, transient_fail_clients=1, nan_clients=1))
# The same through 4 host tiers, b = 4 error feedback and the hybrid-HE
# upload (transciphered on every rank), a lossy uplink.
TIERS = (dict(FLAT[0], num_hosts=4, host_quorum=0.5, ship_deadline_s=1.0, upload_kind="hhe"),
         dict(FLAT[1], num_hosts=4, link_loss_hosts=1))


def rank() -> int:
    return dist.get_rank()


def _setup(num_clients: int, seed: int, n: int, n_per: int = 8):
    (x, y), _, _ = make_dataset("mnist", seed=seed, n_train=n_per * num_clients, n_test=8)
    xs, ys = stack_federated(x, y, iid_contiguous(len(y), num_clients))
    gen = torch.Generator().manual_seed(seed)
    model = create_model("smallcnn", gen=gen, device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=n)
    sk, pk = keys.keygen(ctx, gen, device="cpu")
    return xs, ys, model, params, ctx, sk, pk


def _scenario(name: str, num_clients: int):
    s_kw, f_kw = {"flat": FLAT, "packed": FLAT, "tiers": TIERS}[name]
    return StreamConfig(**s_kw), FaultConfig(**f_kw)


@contextlib.contextmanager
def _capture_uploads(sink: list):
    """Record each `client_uploads` call's trained weights (out[3]) and
    cohort, keyed by call."""
    real = stream.client_uploads

    def spy(*a, **k):
        out = real(*a, **k)
        sink.append((k.get("cohort"), k.get("block"), out[3]))
        return out

    stream.client_uploads = spy
    try:
        yield
    finally:
        stream.client_uploads = real


def _rounds(engine, model, cfg, ctx, pk, params, xs, ys, seed, rounds, spec, hhe, mesh,
            num_clients):
    """`rounds` streaming rounds; on a mesh each rank's rows staged by the
    prefetcher (`stream.round_rows`). -> per round (ct_hash, record, meta,
    the sum, the residual registry's hash)."""
    out = []
    pf = RoundPrefetcher("cpu")
    for r in range(rounds):
        gen = torch.Generator().manual_seed(seed * 100 + r)
        kw = dict(packing=spec, hhe=hhe)
        if mesh is not None:
            rows = stream.round_rows(engine.stream, mesh, r, num_clients)[0]
            xs_r, ys_r = pf.get(xs, ys, rows=rows)
            kw.update(mesh=mesh, num_real_clients=num_clients, resident_rows=rows)
        else:
            xs_r, ys_r = torch.from_numpy(xs), torch.from_numpy(ys)
        ct, mets, overflow, sm = engine.run_round(model, cfg, ctx, pk, params, xs_r, ys_r,
                                                  gen, r, **kw)
        ef = engine._ef_residual
        out.append({"hash": stream.ct_hash(ct.c0, ct.c1), "record": sm.record(),
                    "meta": dataclasses.asdict(sm.meta), "mets": mets.numpy(),
                    "overflow": overflow.numpy(),
                    "ef": None if ef is None else ef.numpy().tobytes().hex()[:64],
                    "sum": (ct.c0.numpy(), ct.c1.numpy(), ct.scale)})
    return out


def stream_rounds(name: str, num_clients: int, seed: int, n: int, rounds: int,
                  backend: str = "vmap") -> dict:
    """The streaming engine on this world's client mesh for `rounds`
    rounds ("flat": float CKKS uploads; "packed": b = 8; "tiers": 4 host
    tiers, b = 4 error feedback, hybrid-HE uploads); rank 0 also the
    one-rank engine on the same inputs, and decrypts both: each committed
    round's average against the plaintext mean of its released clients
    (float and b = 8 uploads; rounds without a stale fold), and the
    mesh's average against the one-rank engine's."""
    xs, ys, model, params, ctx, sk, pk = _setup(num_clients, seed, n)
    s, faults = _scenario(name, num_clients)
    cfg = dataclasses.replace(CFG, client_fusion=backend)
    spec = hhe = None
    if name == "tiers":
        spec = PackedSpec.for_params(params, ctx, PackingConfig(bits=4, clip=0.05,
                                                                error_feedback=True),
                                     num_clients)
        hhe = HheConfig(key_seed=seed)
    elif name == "packed":
        spec = PackedSpec.for_params(params, ctx, PackingConfig(bits=8), num_clients)
    mesh = parallel.make_mesh(num_clients)
    with deterministic_algorithms():
        got = {"mesh": _rounds(stream.StreamEngine(s, faults), model, cfg, ctx, pk, params, xs,
                               ys, seed, rounds, spec, hhe, mesh, num_clients)}
        if rank() != 0:
            for rec in got["mesh"]:
                rec.pop("sum")
            return got
        uploads: list = []
        with _capture_uploads(uploads):
            got["one"] = _rounds(stream.StreamEngine(s, faults), model, cfg, ctx, pk, params,
                                 xs, ys, seed, rounds, spec, hhe, None, num_clients)

    def decrypt(rec):
        c0, c1, scale = rec.pop("sum")
        ct = secure.Ciphertext(c0=torch.from_numpy(c0), c1=torch.from_numpy(c1), scale=scale)
        meta = stream.RoundMeta(**rec["meta"])
        if spec is not None:
            return secure.decrypt_average(ctx, sk, ct, num_clients, meta=meta, packing=spec,
                                          base_params=params, hhe=hhe is not None)
        return secure.decrypt_average(ctx, sk, ct, num_clients,
                                      PackSpec.for_params(params, ctx.n), meta=meta)

    errs, diffs = [], []
    for one, mine, (cohort, _, p_out) in zip(got["one"], got["mesh"], uploads):
        if not one["record"]["committed"]:
            one.pop("sum"), mine.pop("sum")
            errs.append(None)
            continue
        avg, avg_mesh = decrypt(one), decrypt(mine)
        diffs.append(max(float((avg[k] - avg_mesh[k]).abs().max()) for k in avg))
        if name == "tiers" or one["record"]["stale_folded"]:
            errs.append(None)
            continue
        rows = list(cohort) if cohort is not None else list(range(num_clients))
        kept = [p_out[rows.index(c)] for c, on in enumerate(one["meta"]["participation"]) if on]
        ref = {k: torch.stack([p[k] for p in kept]).mean(0) for k in params}
        errs.append(max(float((avg[k] - ref[k]).abs().max()) for k in ref))
    got.update(errs=errs, diffs=diffs,
               budget=None if spec is None else float(spec.error_budget))
    return got


def ct_split(m_res, u, e0, e1, pk: tuple, n: int, num_clients: int, ct: int) -> dict:
    """This rank's client block of the given residues and samples
    (int32[C, n_ct, L, N]) through `secure.ct_sharded_encrypt_core` on
    `make_mesh_2d(C, ct)`: -> the block's clients and its ciphertexts."""
    mesh = parallel.make_mesh_2d(num_clients, ct)
    gidx, _ = fedavg.client_block(mesh, num_clients, None)
    ctx = keys.CkksContext.create(n=n)
    pubk = keys.PublicKey(b_mont=torch.from_numpy(pk[0]), a_mont=torch.from_numpy(pk[1]))
    blk = [torch.from_numpy(a[gidx]) for a in (m_res, u, e0, e1)]
    out = secure.ct_sharded_encrypt_core(ctx, pubk, *blk, mesh)
    return {"block": gidx, "c0": out.c0.numpy(), "c1": out.c1.numpy(),
            "coords": mesh.coords, "record": mesh.record()}


def secure_round_2d(num_clients: int, seed: int, n: int, ct: int, packed: bool = False) -> dict:
    """The encrypted round on this world's ("clients", "ct") mesh and on
    its 1-D client mesh, each rank's block staged by the prefetcher; rank 0
    also the one-device round, and the 2-D round's decrypt against its
    plaintext mean."""
    xs, ys, model, params, ctx, sk, pk = _setup(num_clients, seed, n)
    spec = (PackedSpec.for_params(params, ctx, PackingConfig(bits=8), num_clients)
            if packed else None)

    def run(mesh):
        kw = {}
        if mesh is not None:
            n_dev = parallel.client_mesh_size(mesh)
            rows = fedavg.client_block(mesh, num_clients, fedavg.pad_index(num_clients, n_dev))[0]
            xs_r, ys_r = RoundPrefetcher("cpu").get(xs, ys, rows=rows)
            kw = dict(mesh=mesh, num_real_clients=num_clients, resident_rows=rows)
        else:
            xs_r, ys_r = torch.from_numpy(xs), torch.from_numpy(ys)
        ct_sum, mets, overflow, *rest = secure.secure_fedavg_round(
            model, CFG, ctx, pk, params, xs_r, ys_r, torch.Generator().manual_seed(seed + 1),
            with_plain_reference=True, packing=spec, **kw)
        return ct_sum, mets, overflow, rest[-1]

    mesh2 = parallel.make_mesh_2d(num_clients, ct)
    s2, m2, o2, ref = run(mesh2)
    s1, m1, o1, _ = run(parallel.make_mesh(num_clients))
    got = {"record": mesh2.record(), "coords": mesh2.coords,
           "equal_1d": bool(torch.equal(s2.c0, s1.c0) and torch.equal(s2.c1, s1.c1)
                            and torch.equal(m2, m1) and torch.equal(o2, o1)),
           "hash": stream.ct_hash(s2.c0, s2.c1)}
    if rank() == 0:
        s0, m0, o0, _ = run(None)
        got["equal_one"] = bool(torch.equal(s2.c0, s0.c0) and torch.equal(s2.c1, s0.c1)
                                and torch.equal(m2, m0))
        if packed:
            avg = secure.decrypt_average(ctx, sk, s2, num_clients, packing=spec,
                                         base_params=params)
        else:
            avg = secure.decrypt_average(ctx, sk, s2, num_clients,
                                         PackSpec.for_params(params, ctx.n))
        got["err"] = max(float((avg[k] - ref[k]).abs().max()) for k in ref)
        got["budget"] = None if spec is None else float(spec.error_budget)
    return got


def experiment_run(cfg) -> dict:
    """`run_experiment` in this world -> how it ended, rank 0's history (less
    its timings), the parameters, the journals this rank opened and the
    files it wrote through the checkpoint writers."""
    from hefl_tpu_torch import experiment

    opened, writes = [], []
    real_server = experiment.AggregationServer
    real_writers = (experiment.save_checkpoint, experiment.save_params)

    def server(*a, **k):
        opened.append(k["journal_path"])
        return real_server(*a, **k)

    def count(fn):
        def wrapped(path, *a, **k):
            writes.append(str(path))
            return fn(path, *a, **k)
        return wrapped

    experiment.AggregationServer = server
    experiment.save_checkpoint, experiment.save_params = (count(f) for f in real_writers)
    out, ended = None, "completed"
    try:
        out = experiment.run_experiment(cfg, verbose=False, device="cpu")
    except RuntimeError as e:
        ended = type(e).__name__
    finally:
        experiment.AggregationServer = real_server
        experiment.save_checkpoint, experiment.save_params = real_writers
    got = {"ended": ended, "opened": opened, "writes": writes}
    if out is not None:
        got["history"] = [{k: v for k, v in rec.items() if k not in ("phases", "phase_roofline")}
                          for rec in out["history"]]
        got["params"] = {k: v.numpy() for k, v in out["params"].items()}
        got["mesh"] = out["mesh"]
        got["journal"] = out["journal"]
    return got


def cohort_compare(num_clients: int, cohort_size: int, n: int) -> dict:
    """`cohort_compare_record` on this world's client mesh, each producer
    timed once (the record's geometry and hash gate are what is held)."""
    from hefl_tpu_torch.utils import roofline

    xs, ys, model, params, ctx, _, pk = _setup(num_clients, 3, n, n_per=4)
    real = roofline.steady_seconds
    roofline.steady_seconds = lambda fn, *a, **k: (fn(*a), 1.0)[1]
    try:
        return stream.cohort_compare_record(
            model, CFG, ctx, pk, params, torch.from_numpy(xs), torch.from_numpy(ys), 9,
            num_clients, cohort_size, mesh=parallel.make_mesh(num_clients))
    finally:
        roofline.steady_seconds = real
