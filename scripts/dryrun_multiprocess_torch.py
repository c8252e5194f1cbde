"""The port's sharded training steps across processes, on the CPU.

Counterpart of scripts/dryrun_multiprocess.py for the PyTorch port: two
processes of 4 shards each, joined by ``torch.distributed`` (gloo) through
``parallel.init_process_mesh`` into one 8-shard mesh, run one Adam step
of each of five models, and the same steps run on one process's 8-shard
mesh (one controller) for reference:

  1. frozen-q MagNet on the mxu tier (N=512 DSBM, a sharded MagneticPair);
  2. trainable-q MagNet on a sharded mxu MagneticTemplate (K3 backward,
     dq summed across processes);
  3. SNEA on sharded attention graphs (N=256 SSBM);
  4. SGCN on sharded mxu operators;
  5. SDGNN with one GAT a motif graph on sharded attention graphs.

Each process builds and runs only its own shards; the replicated
parameters' gradients are summed over the processes (``shard_input``), so
both runs must report the same loss and the same parameter norm after the
step, to 1e-6 relative (SNEA's norm without its first layer's attention,
whose gradient is rounding noise: ``NOISE_ONLY``).  Workers run with one
intra-op thread.

Run from the root of a checkout:  python3 scripts/dryrun_multiprocess_torch.py
The last line is one JSON object with "multiprocess_ok".
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TOL = 1e-6
PHASES = ("frozen-q MagNet (mxu)", "trainable-q template (mxu)",
          "attention tier (SNEA)", "signed operators (SGCN, mxu)",
          "motif models (SDGNN per motif)")


def _free_port() -> int:
    """An ephemeral port for the rendezvous: a fixed one collides with a
    stale worker or a concurrent run."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _signed_edges(n):
    import numpy as np
    from pytorch_geometric_signed_directed_tpu_torch.data import SSBM

    (A_p, A_n), _ = SSBM(n, 2, 0.3, 0.1, size_ratio=1,
                         rng=np.random.default_rng(4))
    A = (A_p - A_n).tocoo()
    keep = A.data != 0
    return np.column_stack([A.row[keep], A.col[keep],
                            np.sign(A.data[keep])]).astype(np.int64)


# SNEA's first-layer attention gets no gradient: each destination
# aggregates its own feature over edges that all carry it, so the softmax
# weights cannot move the output (tests/test_torch_snea.py).  Its gradient
# is rounding noise, which Adam scales up to full steps, differently for
# another order of the sums; the norm leaves these parameters out, and
# their gradients must stay noise.
NOISE_ONLY = ("conv1.alpha_b.", "conv1.alpha_u.")


def _step(model, loss_fn):
    """One Adam step at lr 1e-2: (loss before it, parameter norm after)."""
    import torch

    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    loss = loss_fn(model)
    loss.backward()
    for k, p in model.named_parameters():
        if k.startswith(NOISE_ONLY) and float(p.grad.abs().max()) >= 1e-5:
            raise AssertionError(f"{k} has a gradient beyond rounding")
    opt.step()
    norm = torch.sqrt(sum((p.detach().double() ** 2).sum()
                          for k, p in model.named_parameters()
                          if not k.startswith(NOISE_ONLY)))
    return float(loss.detach()), float(norm)


def run_steps(mesh):
    """The five steps on ``mesh``: [(loss, norm)] * 5."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from pytorch_geometric_signed_directed_tpu_torch import parallel
    from pytorch_geometric_signed_directed_tpu_torch.data import DSBM
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        in_out_degree)
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        SDGNN, SGCN, SNEA, MagNet_node_classification)
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        prepare_sdgnn_inputs, prepare_sgcn_inputs, prepare_snea_inputs)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators, magnetic_template)
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        meta_graph_generation)

    cpu = dict(device="cpu")

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    out = []
    n = 512
    Fm = meta_graph_generation("cyclic", 3, 0.05, False)
    A, labels = DSBM(n, 3, 0.3, Fm, rng=np.random.default_rng(1))
    ei = np.vstack(A.nonzero())
    w = A.tocoo().data
    x = in_out_degree(ei, n, edge_weight=w)
    x = torch.from_numpy((x / max(x.max(), 1.0)).astype(np.float32))
    y = torch.from_numpy(np.asarray(labels))
    lap = parallel.shard_magnet_laplacian(magnet_propagators(
        ei, w, q=0.25, num_nodes=n, mode="mxu", **cpu), mesh)
    tmpl = parallel.shard_magnet_laplacian(magnetic_template(
        ei, w, num_nodes=n, mode="mxu", **cpu), mesh)
    assert lap.dual.mode == "mxu_sharded" and tmpl.mode == "mxu_sharded"
    for seed, op, trainable in ((2, lap, False), (3, tmpl, True)):
        model = MagNet_node_classification(
            num_features=2, hidden=16, K=2, label_dim=3, activation=True,
            layer=2, trainable_q=trainable, q=0.25, generator=gen(seed),
            **cpu)
        out.append(_step(model, lambda m, op=op: F.nll_loss(m(x, x, op), y)))

    ns = 256
    es = _signed_edges(ns)
    emb = np.random.default_rng(4).standard_normal((ns, 8)).astype(
        np.float32)
    graphs = parallel.shard_attention_graphs(
        prepare_snea_inputs(ns, es, in_dim=8, init_emb=emb, **cpu)[3], mesh)
    snea = SNEA(ns, in_dim=8, out_dim=8, layer_num=2, init_emb=emb,
                generator=gen(4), **cpu)
    out.append(_step(snea, lambda m: (m(graphs) ** 2).sum()))

    P_pos, P_neg = (parallel.shard_propagator(P, mesh) for P in
                    prepare_sgcn_inputs(ns, es, in_dim=8, init_emb=emb,
                                        mode="mxu", **cpu)[3:5])
    sgcn = SGCN(ns, in_dim=8, out_dim=8, layer_num=2, init_emb=emb,
                generator=gen(5), **cpu)
    out.append(_step(sgcn, lambda m: (m(P_pos, P_neg) ** 2).sum()))

    motifs = parallel.shard_attention_graphs(
        prepare_sdgnn_inputs(ns, es, in_dim=8, init_emb=emb, **cpu)[3], mesh)
    sdgnn = SDGNN(ns, in_dim=8, out_dim=8, layer_num=2, init_emb=emb,
                  generator=gen(6), **cpu)
    out.append(_step(sdgnn, lambda m: (m(motifs) ** 2).sum()))
    return out


def _one_thread():
    import torch

    torch.set_num_threads(1)


def worker(out_path: str, shards: int):
    _one_thread()
    from pytorch_geometric_signed_directed_tpu_torch import parallel
    from pytorch_geometric_signed_directed_tpu_torch.parallel import (
        distributed)

    mesh = parallel.init_process_mesh(shards, device="cpu")
    assert mesh.process.backend == "gloo" and mesh.size == 8
    try:
        results = run_steps(mesh)
    finally:
        distributed.shutdown()
    if mesh.process.rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


def single(out_path: str):
    _one_thread()
    from pytorch_geometric_signed_directed_tpu_torch import parallel

    with open(out_path, "w") as f:
        json.dump(run_steps(parallel.make_mesh(8, device="cpu")), f)


def launch(nprocs: int = 2, timeout: int = 600) -> int:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    with tempfile.TemporaryDirectory() as td:
        ref = os.path.join(td, "single.json")
        subprocess.run([sys.executable, __file__, "--single", "--out", ref],
                       env=env, check=True, cwd=REPO, timeout=timeout)
        multi = os.path.join(td, "multi.json")
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--worker", "--out", multi,
             "--shards", str(8 // nprocs)],
            env=dict(env, RANK=str(r), WORLD_SIZE=str(nprocs),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=port), cwd=REPO)
            for r in range(nprocs)]
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if rcs != [0] * nprocs:
            raise SystemExit(f"workers exited with {rcs}")
        with open(ref) as f:
            rs = json.load(f)
        with open(multi) as f:
            rm = json.load(f)
    ok = True
    for name, (ls, ns), (lm, nm) in zip(PHASES, rs, rm):
        dl = abs(ls - lm) / max(1.0, abs(ls))
        dn = abs(ns - nm) / max(1.0, abs(ns))
        good = dl < TOL and dn < TOL
        ok &= good
        print(f"multiprocess {name}: 1 process x 8 loss={ls:.9g} norm="
              f"{ns:.9g}; {nprocs} x {8 // nprocs} loss={lm:.9g} norm="
              f"{nm:.9g}; rel dloss {dl:.2e} rel dnorm {dn:.2e} "
              f"{'OK' if good else 'FAIL'}")
    print(json.dumps({"multiprocess_ok": bool(ok), "phases": list(PHASES),
                      "single": rs, "multi": rm}))
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help="join the process group named by RANK, "
                         "WORLD_SIZE, MASTER_ADDR and MASTER_PORT")
    ap.add_argument("--shards", type=int, default=4,
                    help="shards a worker runs")
    ap.add_argument("--single", action="store_true",
                    help="the one-process reference")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.worker:
        worker(a.out, a.shards)
    elif a.single:
        single(a.out)
    else:
        sys.exit(launch())


if __name__ == "__main__":
    main()
