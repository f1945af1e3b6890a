"""One rank of a port pod on the CPU, for tests/test_torch_pod.py.

Run as ``python tests/torch_pod_ranks.py PLAN.json`` with the
``TPUMINTER_*`` rendezvous triple in the environment, one process a
rank. It joins the pod over gloo (``device="cpu"``, the kernels' plain
versions) and runs the plan's phases in order, every rank the same:

1. ``sweeps``: each ``parallel.mesh`` sweep called directly on the
   plan's inputs;
2. ``groups``: each group's requests through ``PodMiner(spmd_leader=
   True)`` on rank 0 and ``follower_loop`` on the others, then the
   leader's ``close()``;
3. ``replay`` (optional): a chunk abandoned after one step, then a chunk
   mined to its end, then a chunk in progress when the leader closes;
4. ``lsp`` (optional): rank 0 serves a coordinator at ``[host, port]``
   through ``worker.run_miner`` (whose end closes the miner), the others
   replay.

Each rank writes ``rank{r}.json`` beside the plan: its answers, the
Results its generators produced (followers' included) and the modules of
JAX or the JAX package it loaded, which must be none.
"""

import asyncio
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpuminter_torch import chain, kernels  # noqa: E402
from tpuminter_torch.lsp import Params  # noqa: E402
from tpuminter_torch.ops import merkle  # noqa: E402
from tpuminter_torch.ops import scrypt as scrypt_ops  # noqa: E402
from tpuminter_torch.ops import sha256 as ops  # noqa: E402
from tpuminter_torch.parallel import distributed, mesh  # noqa: E402
from tpuminter_torch.pod_worker import PodMiner, follower_loop  # noqa: E402
from tpuminter_torch.protocol import decode_msg  # noqa: E402
from tpuminter_torch.rolled import plan_tiles  # noqa: E402
from tpuminter_torch.worker import run_miner  # noqa: E402


def fields(result):
    return [result.found, result.nonce, result.hash_value, result.searched]


class RecordingPodMiner(PodMiner):
    """A PodMiner that records each chunk it starts and the Result its
    generator produced (None for a chunk abandoned before its Result)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.replayed = []

    def _mine_impl(self, request):
        self.replayed.append(None)
        for item in super()._mine_impl(request):
            if item is not None:
                self.replayed[-1] = fields(item)
            yield item


def drain(gen):
    results = [item for item in gen if item is not None]
    assert len(results) == 1, results
    return results[0]


def make_miner(pod, group):
    miner = RecordingPodMiner(pod=pod, device="cpu", spmd_leader=pod.is_leader,
                              **group["miner"])
    if group.get("scrypt_n_log2"):
        miner.scrypt_n_log2 = group["scrypt_n_log2"]
    return miner


def run_group(pod, group) -> dict:
    miner = make_miner(pod, group)
    out = {}
    if pod.is_leader:
        for name, raw in group["requests"].items():
            out[name] = fields(drain(miner.mine(decode_msg(raw.encode()))))
        miner.close()
    else:
        follower_loop(miner)
    return {"results": out, "replayed": miner.replayed}


def run_replay(pod, group) -> dict:
    """Abandon a chunk after one step, mine one to its end, then close the
    pod in the middle of a third."""
    miner = make_miner(pod, group)
    out = {}
    if pod.is_leader:
        raws = [decode_msg(r.encode()) for r in group["requests"].values()]
        gen = miner.mine(raws[0])
        assert next(gen) is None
        gen.close()  # as the role loop abandons a cancelled chunk
        out["after_abandon"] = fields(drain(miner.mine(raws[1])))
        gen = miner.mine(raws[0])
        assert next(gen) is None
        miner.close()  # releases the followers mid-chunk, then stops them
        gen.close()
        out["lanes"] = miner.lanes
    else:
        follower_loop(miner)
        out["follower_returned"] = True
    return {"results": out, "replayed": miner.replayed}


def run_sweeps(pod, spec) -> dict:
    """Every mesh sweep on the plan's inputs; each answer as a list."""
    dev = pod.device
    header = bytes.fromhex(spec["header"])
    template = ops.header_template(header)
    target = chain.bits_to_target(chain.BlockHeader.unpack(header).bits)
    cap = int(ops.target_to_words(target)[1])
    out = {}
    c = spec["candidate"]

    def static(base, n):
        return kernels.search_candidates(template, base, n, cap, device=dev)

    words = ops.header_words(template)
    mid = torch.tensor(list(words[0]), dtype=torch.int64)
    tail = torch.tensor(list(words[1:]), dtype=torch.int64)

    def dynamic(base, n):
        return kernels.search_candidates_hdr(mid, tail, base, n, cap)

    span = pod.world * c["slab"] * c["n_slabs"]
    for start in c["starts"]:
        out[f"candidate_{start}"] = list(mesh.candidate_sweep(
            pod, static, start, span, slab=c["slab"], n_slabs=c["n_slabs"]))
        out[f"candidate_dyn_{start}"] = list(mesh.candidate_sweep(
            pod, dynamic, start, span, slab=c["slab"], n_slabs=c["n_slabs"]))
    r = spec["rolled"]
    cb = bytes.fromhex(r["coinbase"])
    job = merkle.build_roll(header, cb[:r["split"]], cb[r["split"] + 1:], 1, ())
    rows = -(-r["rows"] // pod.world) * pod.world
    plan = plan_tiles(r["start"], (rows - 2) * r["width"], 32, r["width"], rows,
                      interleave=pod.world)
    out["rolled"] = list(mesh.rolled_sweep(pod, plan, job, r["width"], cap))
    e = spec["exact"]
    for start in e["starts"]:
        out[f"exact_{start}"] = mesh.exact_sweep(
            pod, template, [int(t) for t in ops.target_to_words(e["target"])], start,
            slab=e["slab"]).read()
    m = spec["min"]
    out["min"] = mesh.min_sweep(pod, ops.toy_template(bytes.fromhex(m["data"])), m["start"],
                                slab=m["slab"]).read()
    s = spec["scrypt"]
    v = kernels.romix_scratch(s["n_log2"], s["batch"], dev)
    hw = scrypt_ops.header_to_words(header[:76])
    for name, tgt in (("found", s["found_target"]), ("exhausted", 1)):
        out[f"scrypt_{name}"] = mesh.scrypt_sweep(
            pod, hw, s["start"], [int(t) for t in ops.target_to_words(tgt)], v,
            batch=s["batch"], n_log2=s["n_log2"]).read()
    return out


def main() -> None:
    plan_path = sys.argv[1]
    with open(plan_path) as fh:
        plan = json.load(fh)
    torch.set_num_threads(1)  # the plain versions are many small torch calls
    pod = distributed.init_from_env("cpu")
    out = {"rank": pod.rank, "world": pod.world, "backend": pod.backend}
    out["sweeps"] = run_sweeps(pod, plan["sweeps"])
    out["groups"] = {g["name"]: run_group(pod, g) for g in plan["groups"]}
    if plan.get("replay"):
        out["replay"] = run_replay(pod, plan["replay"])
    if plan.get("lsp"):
        host, port = plan["lsp"]["addr"]
        miner = make_miner(pod, plan["lsp"])
        if pod.is_leader:
            asyncio.run(run_miner(host, port, miner, params=Params(**plan["lsp"]["params"])))
        else:
            follower_loop(miner)
        out["lsp_replayed"] = miner.replayed
    out["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "tpuminter"))
    pod.close()
    if out["loaded"]:
        raise RuntimeError(f"a pod rank loaded {out['loaded']}")
    with open(os.path.join(os.path.dirname(plan_path), f"rank{pod.rank}.json"), "w") as fh:
        json.dump(out, fh)


if __name__ == "__main__":
    main()
