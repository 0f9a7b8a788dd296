"""Work the spawned ranks of `tests/test_torch_mesh*.py` run.

Each function runs on every rank of a `hefl_tpu_torch.parallel.launch.World`
(gloo on the CPU) and returns numpy values. No JAX here: the ranks import
only torch and the port; the tests hold their results against the JAX
package in the parent process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from hefl_tpu_torch import parallel
from hefl_tpu_torch.ckks import keys
from hefl_tpu_torch.ckks.ops import Ciphertext
from hefl_tpu_torch.ckks.packing import PackSpec
from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
from hefl_tpu_torch.data.synthetic import make_dataset
from hefl_tpu_torch.fl import fedavg, secure
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.models import create_model

CFG = TrainConfig(epochs=1, batch_size=8, num_classes=10)


def rank() -> int:
    return dist.get_rank()


def collectives(x: np.ndarray, p: np.ndarray) -> dict:
    """x int32[world, L, N]: this rank's row through every modular
    all-reduce, and the float rows through pmean_tree."""
    r = rank()
    xt, pt = torch.from_numpy(x[r]), torch.from_numpy(p)
    flat = parallel.make_mesh(dist.get_world_size())
    host = parallel.make_host_mesh(2, dist.get_world_size() // 2)
    return {
        "psum_mod": parallel.psum_mod(xt, pt, flat, "clients").numpy(),
        "ring_psum_mod": parallel.ring_psum_mod(xt, pt, flat, "clients").numpy(),
        "reduce_mod": parallel.reduce_mod(xt, pt, flat, "clients").numpy(),
        "hierarchical": parallel.hierarchical_psum_mod(
            xt, pt, host, parallel.client_axes(host)).numpy(),
        "host_rows": parallel.psum_mod(xt, pt, host, "clients").numpy(),
    }


def pmean(trees: list[dict]) -> dict:
    """Rank r's float dict trees[r] through pmean_tree over the client axis."""
    mesh = parallel.make_mesh(dist.get_world_size())
    tree = {k: torch.from_numpy(v) for k, v in trees[rank()].items()}
    return {k: v.numpy() for k, v in parallel.pmean_tree(tree, mesh, "clients").items()}


def masked_mean(gp: dict, trees: list[dict], keep: list[bool]) -> tuple[dict, float]:
    """This rank's block of client trees through `masked_mean_tree(mesh=)`."""
    mesh = parallel.make_mesh(len(trees))
    gidx, _ = fedavg.client_block(mesh, len(trees), None)
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    out, count = fedavg.masked_mean_tree(
        t(gp), [t(trees[i]) for i in gidx], torch.tensor([keep[i] for i in gidx]),
        len(trees), mesh=mesh)
    return {k: v.numpy() for k, v in out.items()}, float(count)


def he_half(trees: list[dict], samples: tuple, pk: tuple, n: int, keep: list[bool]) -> dict:
    """The sharded HE half of a round on given weights and samples: this
    rank's block (padded as the round pads) encrypted, its excluded rows
    zeroed, summed, and the partials all-reduced mod p."""
    num = len(trees)
    mesh = parallel.make_mesh(num)
    ctx = keys.CkksContext.create(n=n)
    pubk = keys.PublicKey(b_mont=torch.from_numpy(pk[0]), a_mont=torch.from_numpy(pk[1]))
    pad = fedavg.pad_index(num, parallel.client_mesh_size(mesh))
    gidx, rows = fedavg.client_block(mesh, num, pad)
    p_out = [{k: torch.from_numpy(v) for k, v in trees[i].items()} for i in gidx]
    blk = tuple(torch.from_numpy(s[gidx]) for s in samples)
    ct = secure.encrypt_stack(ctx, pubk, p_out, samples=blk)
    keep_blk = torch.tensor([bool(keep[i]) for i in gidx])
    keep_blk[rows:] = False
    local = secure.aggregate_encrypted(ctx, secure.zero_excluded(ct, keep_blk))
    total = secure.psum_ciphertext(ctx, local, mesh)
    return {"c0": total.c0.numpy(), "c1": total.c1.numpy()}


def _data(num_clients: int, seed: int, n_per: int = 8):
    (x, y), _, _ = make_dataset("mnist", seed=seed, n_train=n_per * num_clients, n_test=8)
    return stack_federated(x, y, iid_contiguous(len(y), num_clients))


def _setup(num_clients: int, seed: int, n: int):
    xs, ys = _data(num_clients, seed)
    gen = torch.Generator().manual_seed(seed)
    model = create_model("smallcnn", gen=gen, device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=n)
    sk, pk = keys.keygen(ctx, gen, device="cpu")
    return xs, ys, model, params, ctx, sk, pk


def _np_ct(ct: Ciphertext) -> dict:
    return {"c0": ct.c0.numpy(), "c1": ct.c1.numpy()}


def secure_round(num_clients: int, seed: int, n: int, participation=None, prepad: bool = False,
                 cfg: TrainConfig = CFG) -> dict:
    """The sharded encrypted round on this world's mesh, with its plain
    reference; rank 0 also runs the one-device round on the same inputs
    (no mesh) and decrypts both."""
    xs, ys, model, params, ctx, sk, pk = _setup(num_clients, seed, n)
    mesh = parallel.make_mesh(num_clients)
    xs_r, ys_r, num_real = (fedavg.pad_federated(xs, ys, parallel.client_mesh_size(mesh))
                            if prepad else (xs, ys, None))
    outs = secure.secure_fedavg_round(
        model, cfg, ctx, pk, params, torch.from_numpy(xs_r), torch.from_numpy(ys_r),
        torch.Generator().manual_seed(seed + 1), with_plain_reference=True,
        participation=participation, mesh=mesh, num_real_clients=num_real)
    ct_sum, mets, overflow, *rest = outs
    ref = rest[-1]
    meta = rest[0] if len(rest) == 2 else None
    got = {"sum": _np_ct(ct_sum), "mets": mets.numpy(), "overflow": overflow.numpy(),
           "meta": None if meta is None else dataclasses.asdict(meta)}
    if rank() != 0:
        return got
    spec = PackSpec.for_params(params, ctx.n)
    avg = secure.decrypt_average(ctx, sk, ct_sum, num_clients, spec, meta=meta)
    got["avg_vs_ref"] = max(float((avg[k] - ref[k]).abs().max()) for k in ref)
    one = secure.secure_fedavg_round(
        model, cfg, ctx, pk, params, torch.from_numpy(xs), torch.from_numpy(ys),
        torch.Generator().manual_seed(seed + 1), with_plain_reference=True,
        participation=participation)
    o_sum, o_mets, o_overflow, *o_rest = one
    o_meta = o_rest[0] if len(o_rest) == 2 else None
    got["one"] = {"sum": _np_ct(o_sum), "mets": o_mets.numpy(), "overflow": o_overflow.numpy(),
                  "meta": None if o_meta is None else dataclasses.asdict(o_meta)}
    got["ref_vs_one_ref"] = max(float((ref[k] - o_rest[-1][k]).abs().max()) for k in ref)
    return got


def plain_round(num_clients: int, seed: int, participation=None) -> dict:
    """The plaintext round on this world's mesh; rank 0 also the one-device
    round on the same inputs."""
    xs, ys, model, params, *_ = _setup(num_clients, seed, 256)
    mesh = parallel.make_mesh(num_clients)

    def run(m):
        outs = fedavg.fedavg_round(model, CFG, params, torch.from_numpy(xs), torch.from_numpy(ys),
                                   torch.Generator().manual_seed(seed + 1),
                                   participation=participation, mesh=m)
        new, mets, *meta = outs
        return {"params": {k: v.numpy() for k, v in new.items()}, "mets": mets.numpy(),
                "meta": dataclasses.asdict(meta[0]) if meta else None}

    got = run(mesh)
    if rank() == 0:
        got["one"] = run(None)
    return got


def owner_he(n: int, seed: int) -> dict:
    """encrypt_params_sharded / decrypt_average(mesh=) over the world's ct
    mesh against the one-device calls on the same generator."""
    _, _, model, params, ctx, sk, pk = _setup(2, seed, n)
    mesh = parallel.make_ct_mesh()
    ct = secure.encrypt_params_sharded(ctx, pk, params, torch.Generator().manual_seed(7), mesh)
    one = secure.encrypt_params(ctx, pk, params, torch.Generator().manual_seed(7))
    spec = PackSpec.for_params(params, ctx.n)
    avg = secure.decrypt_average(ctx, sk, ct, 1, spec, mesh=mesh)
    one_avg = secure.decrypt_average(ctx, sk, one, 1, spec)
    return {"ct_equal": bool(torch.equal(ct.c0, one.c0) and torch.equal(ct.c1, one.c1)),
            "avg_equal": all(torch.equal(avg[k], one_avg[k]) for k in avg)}


def experiment_run(cfg, out_dir: str) -> dict:
    """run_experiment in this world, counting the files each rank writes."""
    from hefl_tpu_torch import experiment

    writes = []
    orig = (experiment.save_checkpoint, experiment.save_params)

    def count(fn):
        def wrapped(path, *a, **k):
            writes.append(str(path))
            return fn(path, *a, **k)
        return wrapped

    experiment.save_checkpoint, experiment.save_params = (count(f) for f in orig)
    try:
        out = experiment.run_experiment(cfg, verbose=False, device="cpu")
    finally:
        experiment.save_checkpoint, experiment.save_params = orig
    hist = [{k: v for k, v in rec.items() if k not in ("phases", "phase_roofline")}
            for rec in out["history"]]
    return {"history": hist, "writes": writes, "mesh": out["mesh"],
            "params": {k: v.numpy() for k, v in out["params"].items()}}


def raise_on(r: int) -> int:
    if rank() == r:
        raise ValueError(f"rank {r} fails on purpose")
    return rank()


def experiment_one_rank_fault(cfg, fail_rank: int) -> dict:
    """run_experiment in this world with rank `fail_rank`'s first training
    call raising a RuntimeError, a fault of that rank alone -> how the run
    ended on this rank and the training calls it made."""
    from hefl_tpu_torch import experiment

    calls = []
    real = fedavg.train_block

    def train_block(*a, **k):
        calls.append(1)
        if rank() == fail_rank and len(calls) == 1:
            raise RuntimeError(f"rank {fail_rank}: injected fault")
        return real(*a, **k)

    fedavg.train_block = train_block
    try:
        experiment.run_experiment(cfg, verbose=False, device="cpu")
        ended = "completed"
    except RuntimeError as e:
        ended = f"{type(e).__name__}: {e}"
    finally:
        fedavg.train_block = real
    return {"ended": ended, "calls": len(calls)}


def agreed_shift_backend(pins: list) -> list:
    """Each rank's HEFL_AUG_SHIFT value from `pins` (rank 0 "fft", the
    next "dft"...) -> [the backend `fedavg.agree_shift_backend` pins here
    for an unpinned config, the one a pinned config keeps]."""
    from hefl_tpu_torch.data import augment

    augment._ENV_BACKEND = pins[rank()]
    mesh = parallel.make_mesh(dist.get_world_size())
    agreed = fedavg.agree_shift_backend(CFG, mesh, torch.device("cpu")).aug_backend
    pinned = dataclasses.replace(CFG, aug_backend="gather")
    return [agreed, fedavg.agree_shift_backend(pinned, mesh, torch.device("cpu")).aug_backend]
