"""Two processes, one chains mesh: the port's counterpart of
tests/test_multihost.py.

Two CPU processes join one gloo process group through
``klara_tpu_torch.parallel.initialize_distributed`` (a ``file://`` init, so
parallel test workers never race for a port), build one global chains mesh
over both, and run MALA with pooled tuning, whose adaptation all-reduces
across the process boundary.  Both processes must compute the same global
posterior summary (``stats.mean``, ``stats.acceptance``), as every JAX
process gets the replicated result of a reduction over the global chains
axis.  The worker is this file's ``__main__`` branch.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(pid: int, nproc: int, init_file: str, outdir: str) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    import klara_tpu_torch as kt
    from klara_tpu_torch.parallel import chain_mesh, initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed("file://" + init_file, nproc, pid, device="cpu")
    assert dist.get_world_size() == nproc, dist.get_world_size()
    mesh = chain_mesh(device="cpu")  # global mesh over both processes
    target = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=2)
    job = kt.MCJob(
        target,
        kt.MALA(driftstep=0.5),
        kt.MCRange(n_steps=400, burnin=100),
        tuner=kt.AcceptanceRateTuner(targetrate=0.6),
        n_chains=32,
        mesh=mesh,
        pooled_tuning=True,  # cross-process pooled adaptation
    )
    chain = job.run(torch.Generator().manual_seed(0), torch.zeros(2))
    assert chain.value.shape == (300, 16, 2), chain.value.shape  # this process's block
    mean = kt.stats.mean(chain)
    rate = float(kt.stats.acceptance(chain))
    assert bool((mean.abs() < 0.25).all()), mean
    assert 0.3 < rate < 0.9, rate
    with open(os.path.join(outdir, f"proc{pid}.ok"), "w") as f:
        f.write(f"{mean.tolist()} {rate!r}\n")
    print(f"proc {pid}: mean={mean} rate={rate:.3f} OK")
    dist.destroy_process_group()


def test_two_process_global_mesh(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    init_file = str(tmp_path / "pg")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "worker", str(pid), "2", init_file, str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert (tmp_path / f"proc{pid}.ok").exists(), out
    # both processes computed the same replicated posterior summary
    assert (tmp_path / "proc0.ok").read_text() == (tmp_path / "proc1.ok").read_text()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
