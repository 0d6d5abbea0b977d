"""Serving launcher: batched prefill + greedy decode, with PIMCQG retrieval
in the loop (counterpart of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch h2o-danube-1.8b --rag

``run`` serves the arch's smoke config with random weights drawn from
``--seed``, as the JAX package does; ``generate`` is the loop itself
(prefill -> decode -> retrieval) and serves any model, full width included.
--rag wires the engine into the decode loop through a pluggable QUERY
ENCODER: after the first decode step, its logits become a (B, dim) query
batch that streams into the engine through

  * ``StreamingScheduler`` (the default, one engine);
  * ``FleetScheduler(replicate_engine(...))`` with --fleet N (N replicas);
  * ``TopologyConfig(shards=N, replicas=R).build`` with --fleet N --sharded
    (the index partitioned across N engines, scatter / gather / merge).

--tenants "name:weight[:backend],..." tags the retrieval stream with
tenants (round-robin over the decode batch) behind the tier's DWRR
admission; tenant backends become the shard partitions' modes,
round-robin. --zipf S replaces the encoded queries with a Zipf(S)-skewed
workload over the corpus clusters (``data/synthetic.zipf_query_set``).

--churn F runs one day-2 mutation round before retrieval (``churn_round``):
the corpus is indexed through a ``MutableIndex`` (bounded append slabs and
tombstones), an F fraction of it is deleted and as many new vectors are
inserted, the dirty clusters are compacted, and the result is swapped into
the live scheduler (``ServingTopology.apply`` on the sharded tier,
``engine.refresh`` on one engine). With --fleet > 1 it needs --sharded: the
replicated FleetScheduler carries no mutation path.

--exec mesh serves the sharded tier from a mesh of processes, one rank a
shard, launched by torchrun with one process per --fleet shard:

    torchrun --nproc-per-node=2 -m repro_torch.launch.serve \
        --arch h2o-danube-1.8b --rag --fleet 2 --sharded --exec mesh

Rank 0 builds the model and the index and serves; the other ranks hold
their partitions and follow it (``execbackend.MeshBackend``). Without a
process group of --fleet ranks, ``launch.mesh.make_shard_mesh`` raises.
--device cpu runs every rank on the CPU (gloo).

--sharded / --replicas without --fleet >= 2 is an argument ERROR, not a
silent single-engine run.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, NamedTuple, Protocol

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_smoke
from ..core import compact_index, engine
from ..core.backends import available_backends
from ..core.fleet import FleetScheduler, TenantSpec, TopologyConfig, \
    replicate_engine
from ..core.mutable_index import MutableIndex
from ..core.execbackend import MeshBackend
from ..core.pipeline import StreamingScheduler, bucket_ladder
from ..core.topology import ServingTopology
from ..data.synthetic import clustered_vectors, zipf_query_set
from ..models.model import Model, build_model
from . import mesh as mesh_mod

__all__ = ["QueryEncoder", "mean_pool_encoder", "logit_slice_encoder",
           "ENCODERS", "parse_tenants", "check_flags", "Generation",
           "generate", "churn_round", "run", "main"]


class QueryEncoder(Protocol):
    """Maps decode-step logits to retrieval queries.

    __call__(logits (B, T, vocab) tensor) -> (B, dim) np.float32: one query
    embedding per in-flight request, in the engine's vector space."""

    def __call__(self, logits: torch.Tensor) -> np.ndarray: ...


def mean_pool_encoder(params, dim: int) -> QueryEncoder:
    """Default encoder: probability-weighted mean token embedding.

    Mean-pools the logits over positions, softmaxes over the vocab, and
    takes the expected row of the model's own embedding table, truncated to
    the engine's ``dim`` and L2-normalized."""
    emb = params["embed"]
    if emb.shape[-1] < dim:
        raise ValueError(f"d_model {emb.shape[-1]} < engine dim {dim}")

    def encode(logits: torch.Tensor) -> np.ndarray:
        p = torch.softmax(logits.float().mean(1), -1)
        e = (p @ emb[:p.shape[-1]].float())[:, :dim]       # (B, dim)
        e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True),
                            min=1e-6)
        return e.cpu().numpy().astype(np.float32)

    return encode


def logit_slice_encoder(dim: int) -> QueryEncoder:
    """The historical stub (first ``dim`` logits of position 0), kept as a
    named alternative encoder."""
    def encode(logits: torch.Tensor) -> np.ndarray:
        return logits[:, 0, :dim].float().cpu().numpy()
    return encode


# name -> factory(params, dim); resolved INSIDE run() where the engine dim
# is known, so CLIs pass names and never duplicate the dimension
ENCODERS: dict[str, Callable[..., QueryEncoder]] = {
    "mean-pool": mean_pool_encoder,
    "logit-slice": lambda params, dim: logit_slice_encoder(dim),
}


def parse_tenants(spec: str) -> list[TenantSpec]:
    """Parse --tenants "name:weight[:backend],..." into TenantSpecs; every
    malformed entry raises ValueError with the offending text."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            raise ValueError(f"--tenants has an empty entry: {spec!r}")
        parts = [p.strip() for p in entry.split(":")]
        if len(parts) not in (2, 3) or not parts[0]:
            raise ValueError(
                f"bad tenant entry {entry!r}: expected name:weight[:backend]")
        name = parts[0]
        try:
            weight = float(parts[1])
        except ValueError:
            raise ValueError(f"tenant {name!r}: weight {parts[1]!r} is not "
                             f"a number") from None
        if not weight > 0:
            raise ValueError(
                f"tenant {name!r}: weight must be > 0, got {weight}")
        backend = parts[2] if len(parts) == 3 else None
        if backend is not None and backend not in available_backends():
            raise ValueError(
                f"tenant {name!r}: unknown backend {backend!r}; registered "
                f"backends: {available_backends()}")
        out.append(TenantSpec(name=name, weight=weight, backend=backend))
    names = [t.name for t in out]
    if len(set(names)) != len(names):
        raise ValueError(f"--tenants has duplicate tenant names: {names}")
    return out


class Generation(NamedTuple):
    tokens: torch.Tensor       # (B, gen) int32 greedy tokens
    logits: torch.Tensor       # (B, 1, Vpad) logits of the last step
    report: Any                # the retrieval's report, None without one
    queries: np.ndarray | None  # the encoded retrieval queries
    prefill_s: float           # host clock, ended by a synchronise
    decode_s: float            # the gen - 1 decode steps, retrieval excluded
    retrieve_s: float          # encoder + scheduler.run, host clock


def generate(model: Model, params, tokens: torch.Tensor, gen: int, cache, *,
             scheduler=None, encoder: QueryEncoder | None = None,
             tenant=None) -> Generation:
    """Prefill ``tokens`` (B, S) into ``cache``, then greedy-decode until
    ``gen`` tokens are out. With a scheduler, the encoder turns the first
    decode step's logits into queries and the scheduler serves them (the
    RAG hook of the JAX package's loop), tagged with ``tenant`` (one name
    a query) when given. On a card the steps are timed on the host clock,
    each phase ended by a synchronise."""
    if (scheduler is None) != (encoder is None):
        raise ValueError("retrieval needs both a scheduler and an encoder")
    cuda = tokens.device.type == "cuda"

    def now():
        if cuda:
            torch.cuda.synchronize(tokens.device)
        return time.perf_counter()

    t0 = now()
    logits, cache = model.prefill(params, tokens, cache)
    out = [torch.argmax(logits[:, -1:], -1).to(torch.int32)]
    t1 = now()
    report = queries = None
    retrieve_s = 0.0
    for i in range(gen - 1):
        logits, cache = model.decode(params, out[-1], cache)
        out.append(torch.argmax(logits[:, -1:], -1).to(torch.int32))
        if scheduler is not None and i == 0:
            tr = now()
            queries = encoder(logits)
            report = scheduler.run(queries) if tenant is None \
                else scheduler.run(queries, tenant=tenant)
            retrieve_s = now() - tr
    t2 = now()
    return Generation(torch.cat(out, dim=1), logits, report, queries,
                      t1 - t0, t2 - t1 - retrieve_s, retrieve_s)


def check_flags(rag: bool, fleet: int, sharded: bool, replicas: int,
                exec: str, tenants, churn: float, zipf: float | None) -> None:
    """The JAX package's flag checks, with its messages (ValueError)."""
    if sharded and fleet < 2:
        raise ValueError(
            f"--sharded partitions the index across the fleet and needs "
            f"--fleet >= 2 (got --fleet {fleet}); a single engine has "
            f"nothing to partition")
    if replicas > 1 and not sharded:
        raise ValueError(
            f"--replicas {replicas} replicates each PARTITION and needs "
            f"--sharded; for plain replication use --fleet N alone")
    if replicas < 1:
        raise ValueError(f"--replicas must be >= 1, got {replicas}")
    if exec != "inproc" and not sharded:
        raise ValueError(
            f"--exec {exec} runs the SHARDED scatter/gather on a device "
            f"mesh and needs --sharded (with --fleet >= 2)")
    if exec == "mesh" and replicas > 1:
        raise ValueError(
            "--exec mesh drives one device per shard; replication on the "
            "mesh is a multi-process launch, not --replicas")
    if not 0.0 <= churn < 1.0:
        raise ValueError(f"--churn must be in [0, 1), got {churn}")
    if churn > 0 and not rag:
        raise ValueError("--churn mutates the retrieval corpus and "
                         "needs --rag")
    if zipf is not None:
        if not zipf > 0:
            raise ValueError(f"--zipf exponent must be > 0, got {zipf}")
        if not rag:
            raise ValueError("--zipf skews the retrieval stream and "
                             "needs --rag")
    if churn > 0 and fleet > 1 and not sharded:
        raise ValueError(
            "--churn needs the typed mutable topology (--sharded) or a "
            "single engine; the replicated FleetScheduler facade carries "
            "no day-2 mutation path")
    if tenants is not None:
        specs = parse_tenants(tenants) if isinstance(tenants, str) \
            else list(tenants)
        if not rag:
            raise ValueError("--tenants tags the retrieval stream and "
                             "needs --rag")
        if fleet < 2:
            raise ValueError(
                f"--tenants needs a serving topology to arbitrate "
                f"(--fleet >= 2; got --fleet {fleet})")
        tenant_backends = sorted({t.backend for t in specs
                                  if t.backend is not None})
        if tenant_backends and not sharded:
            raise ValueError(
                f"tenant backends {tenant_backends} pin tenants to shard "
                f"modes and need --sharded")
        if tenant_backends and fleet < len(tenant_backends):
            raise ValueError(
                f"{len(tenant_backends)} tenant backends "
                f"{tenant_backends} need --fleet >= {len(tenant_backends)} "
                f"shards to serve them (got --fleet {fleet})")


def churn_round(mut: MutableIndex, churn: float, seed: int, first_id: int,
                scheduler, eng) -> tuple[int, list[int]]:
    """One --churn round: delete the first ``churn`` fraction of the live
    ids, insert as many ``default_rng(seed + 1)`` normal vectors under ids
    from ``first_id`` up, compact the dirty clusters and swap the result
    into the live scheduler (``apply`` on a topology, else
    ``eng.refresh``). Returns (rows churned, clusters compacted)."""
    n_churn = max(1, int(round(churn * mut.n_live)))
    mut.delete(mut.live_ids()[:n_churn])
    rng = np.random.default_rng(seed + 1)
    mut.insert(np.arange(first_id, first_id + n_churn),
               rng.standard_normal((n_churn, mut.dim)).astype(np.float32))
    compacted = mut.compact()
    if isinstance(scheduler, ServingTopology):
        scheduler.apply(mut)
    else:
        eng.refresh(*mut.snapshot())
    return n_churn, compacted


def run(arch: str, requests: int, prompt_len: int, gen: int,
        rag: bool = False, seed: int = 0, verbose: bool = True,
        query_encoder: QueryEncoder | str | None = None, fleet: int = 1,
        sharded: bool = False, replicas: int = 1, exec: str = "inproc",
        tenants: str | list | None = None, churn: float = 0.0,
        zipf: float | None = None, device="cuda"):
    """The JAX package's ``run`` on the port: the arch's smoke config with
    random weights from ``seed``; returns (tokens (B, gen) numpy, retrieved
    ids or None). With ``exec="mesh"`` it runs on every rank of a process
    group of ``fleet`` ranks: rank 0 serves, the others follow it and
    return (None, None)."""
    check_flags(rag, fleet, sharded, replicas, exec, tenants, churn, zipf)
    if exec == "mesh":
        mesh = mesh_mod.make_shard_mesh(fleet, device=device)
        if dist.get_rank() != 0:
            MeshBackend.follow(mesh, mesh_mod.rank_device(dist.get_rank(),
                                                          device))
            return None, None
        exec = MeshBackend(mesh=mesh)
        try:
            return _run(arch, requests, prompt_len, gen, rag, seed, verbose,
                        query_encoder, fleet, sharded, replicas, exec,
                        tenants, churn, zipf, device)
        finally:
            exec.close()
    return _run(arch, requests, prompt_len, gen, rag, seed, verbose,
                query_encoder, fleet, sharded, replicas, exec, tenants,
                churn, zipf, device)


def _run(arch, requests, prompt_len, gen, rag, seed, verbose, query_encoder,
         fleet, sharded, replicas, exec, tenants, churn, zipf, device):
    specs = None
    if tenants is not None:
        specs = parse_tenants(tenants) if isinstance(tenants, str) \
            else list(tenants)
    device = torch.device(device)
    cfg = get_smoke(arch)
    model = build_model(cfg)
    gen_ = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen_)

    scheduler = encoder = None
    if rag:
        x, _ = clustered_vectors(seed, 2000, 32, 8)
        icfg = compact_index.IndexConfig(dim=32, n_clusters=8, degree=8,
                                         knn_k=16)
        scfg = engine.SearchConfig(nprobe=2, ef=16, k=4)
        if churn > 0:
            # a mutable corpus with slab room for one churn round even if
            # every insert routes to one cluster
            n_churn = max(1, int(round(churn * len(x))))
            mut = MutableIndex.build(seed, x, icfg, slab=max(16, n_churn),
                                     device=device)
            eng = mut.to_engine(scfg, n_shards=2)
        else:
            eng = engine.PIMCQGEngine.build(seed, x, icfg, scfg, n_shards=2,
                                            device=device)
        stream = dict(buckets=bucket_ladder(max(requests, 1)),
                      fill_threshold=max(requests // 2, 1),
                      wait_limit_s=5e-3)
        modes = None
        if specs is not None:
            tenant_backends = sorted({t.backend for t in specs
                                      if t.backend is not None})
            if tenant_backends:
                # spread the tenants' backends across the partitions
                modes = [tenant_backends[o % len(tenant_backends)]
                         for o in range(fleet)]
        if fleet > 1 and sharded:
            scheduler = TopologyConfig(shards=fleet, replicas=replicas,
                                       modes=modes, tenants=specs,
                                       mutable=churn > 0, exec=exec,
                                       **stream).build(eng)
        elif fleet > 1:
            scheduler = FleetScheduler(replicate_engine(eng, fleet),
                                       tenants=specs, **stream)
        else:
            scheduler = StreamingScheduler(eng, **stream)
        if query_encoder is None:
            query_encoder = "mean-pool"
        encoder = ENCODERS[query_encoder](params, icfg.dim) \
            if isinstance(query_encoder, str) else query_encoder
        if zipf is not None:
            # a Zipf(S) workload over the corpus clusters in place of the
            # encoded queries (a workload knob, not the model's)
            cents = eng.index.centroids.cpu().numpy()
            assign = np.argmin(((x[:, None, :] - cents[None, :, :]) ** 2)
                               .sum(-1), axis=1).astype(np.int32)
            zq, zipf_targets = zipf_query_set(seed, x, assign, requests,
                                              s=zipf)
            encoder = lambda logits: zq          # noqa: E731
        if churn > 0:
            n_churn, compacted = churn_round(mut, churn, seed, len(x),
                                             scheduler, eng)
            if verbose:
                print(f"[serve] rag: churned {n_churn} deletes + "
                      f"{n_churn} inserts ({churn:.1%}), compacted "
                      f"{len(compacted)} clusters, swapped live")

    B = requests
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt_len),
                           generator=gen_, device=device)
    cache = model.init_cache(B, prompt_len + gen, dtype=torch.float32,
                             device=device)
    t0 = time.perf_counter()
    labels = None if specs is None or scheduler is None else \
        [specs[j % len(specs)].name for j in range(B)]
    out = generate(model, params, tokens, gen, cache, scheduler=scheduler,
                   encoder=encoder, tenant=labels)
    dt = time.perf_counter() - t0
    rep = out.report
    retrieved = None if rep is None else rep.ids
    if verbose:
        print(f"[serve] {B} requests x ({prompt_len} prompt + {gen} gen) "
              f"in {dt:.2f}s -> {B * gen / dt:.1f} tok/s")
        if retrieved is not None:
            print(f"[serve] rag: retrieved neighbor ids (first 4 reqs): "
                  f"{retrieved[:4, :4].tolist()}")
            if zipf is not None:
                hist = np.bincount(zipf_targets)
                hot = np.argsort(-hist, kind="stable")[:3]
                print(f"[serve] rag: zipf(s={zipf:g}) workload — hottest "
                      f"clusters {hot.tolist()} hold "
                      f"{hist[hot].sum() / max(hist.sum(), 1):.0%} of "
                      f"{len(zipf_targets)} queries")
            if fleet > 1 and sharded:
                shares = [d["queries"] for d in rep.per_engine]
                sizes = [d["clusters"] for d in rep.per_engine]
                print(f"[serve] rag: sharded fleet={fleet}x{replicas} "
                      f"exec={rep.exec} clusters/engine={sizes} "
                      f"fanout={rep.fanout_mean:.2f} "
                      f"scatter flushes={rep.n_flushes} "
                      f"merges={rep.n_merges} "
                      f"per-engine queries={shares} "
                      f"shed={rep.shed_fraction:.2f} p50={rep.p50_ms:.1f}ms")
            elif fleet > 1:
                shares = [d["queries"] for d in rep.per_engine]
                print(f"[serve] rag: fleet={fleet} ({rep.route}) "
                      f"buckets={scheduler.buckets} "
                      f"flushes={rep.n_flushes} "
                      f"per-engine queries={shares} "
                      f"shed={rep.shed_fraction:.2f} p50={rep.p50_ms:.1f}ms")
            else:
                print(f"[serve] rag: scheduler buckets={scheduler.buckets} "
                      f"flushes={rep.n_flushes} compiles={rep.compiles} "
                      f"p50={rep.p50_ms:.1f}ms")
            if specs is not None and getattr(rep, "tenants", None):
                for name, st in rep.tenants.items():
                    print(f"[serve] rag: tenant {name!r} w={st['weight']:g} "
                          f"backend={st['backend'] or 'any'} "
                          f"queries={st['n_queries']} shed={st['n_shed']} "
                          f"p50={st['p50_ms']:.1f}ms")
    return out.tokens.cpu().numpy(), retrieved


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--encoder", default="mean-pool", choices=list(ENCODERS),
                    help="query encoder for --rag (default: probability-"
                         "weighted mean token embedding)")
    ap.add_argument("--fleet", type=int, default=1,
                    help="shard --rag retrieval across N engine replicas "
                         "via the FleetScheduler (default 1: single-engine "
                         "StreamingScheduler)")
    ap.add_argument("--sharded", action="store_true",
                    help="with --fleet N: PARTITION the index across the N "
                         "engines instead of replicating it")
    ap.add_argument("--replicas", type=int, default=1,
                    help="with --fleet N --sharded: replicate EACH "
                         "partition this many ways (default 1)")
    ap.add_argument("--exec", default="inproc", choices=["inproc", "mesh"],
                    help="with --fleet N --sharded: execution backend "
                         "('mesh': one process a shard, under torchrun "
                         "--nproc-per-node=N)")
    ap.add_argument("--tenants", default=None,
                    help="with --rag --fleet >= 2: tag the retrieval stream "
                         "with tenants, name:weight[:backend],...")
    ap.add_argument("--zipf", type=float, default=None, metavar="S",
                    help="with --rag: Zipf(S)-skewed retrieval queries over "
                         "the corpus clusters in place of the encoded ones")
    ap.add_argument("--churn", type=float, default=0.0,
                    help="with --rag: delete+insert this fraction of the "
                         "retrieval corpus through the streaming mutation "
                         "tier (MutableIndex), compact, and swap the result "
                         "into the live scheduler before retrieval "
                         "(needs --sharded when --fleet > 1)")
    ap.add_argument("--device", default="cuda",
                    help="where to serve (default the card; 'cpu' runs "
                         "the plain versions of the kernels)")
    args = ap.parse_args()
    try:
        check_flags(args.rag, args.fleet, args.sharded, args.replicas,
                    args.exec, args.tenants, args.churn, args.zipf)
    except ValueError as e:    # flag misuse: exit 2 with usage
        ap.error(str(e))
    if args.exec == "mesh":
        mesh_mod.init_from_env(args.device)
    try:
        run(args.arch, args.requests, args.prompt_len, args.gen, args.rag,
            query_encoder=args.encoder, fleet=args.fleet,
            sharded=args.sharded, replicas=args.replicas, exec=args.exec,
            tenants=args.tenants, churn=args.churn, zipf=args.zipf,
            device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
