"""Race demo on the PyTorch port: step.check catching an unsynchronized
read-modify-write on a device tensor.

Two host threads both run the classic racy counter update

    v = counter.get()          # read
    counter.set(v + tid + 1)   # write computed from a stale read

with no barrier between them, so the two RMWs are unordered in the
happens-before order the checker tracks (only spawn/join edges exist) and the
written values differ per thread — a textbook lost-update race.  Armed via
``Session(check=True)``, the vector-clock detector flags the unordered
read/write and write/write pairs and reports *both* stack sites.

The second half runs the fixed program — same update, but each thread owns a
disjoint round via a DBarrier hand-off — and shows the checker stays silent.

    PYTHONPATH=src python examples/torch_race_demo.py                # the card
    PYTHONPATH=src python examples/torch_race_demo.py --device cpu
"""

import argparse

import torch

from repro_torch.core import Session


def racy(device=None):
    sess = Session(backend="host", n_nodes=1, threads_per_node=2, check=True,
                   device=device)
    counter = sess.def_global("counter", torch.tensor(0.0))

    def proc(ctx):
        for _ in range(4):
            v = counter.get()                                  # site A: racy read
            counter.set(v + torch.tensor(ctx.tid + 1.0, device=ctx.device))  # site B: racy write
        return None

    sess.run(proc)
    findings = sess.findings()
    print(f"racy program on {sess.device}: {len(findings)} finding(s)")
    for f in findings:
        print(f"  [{f.kind}] {f.message}")
        for site in f.sites:
            print(f"      site: {site}")
    sess.checker.disable()
    return findings


def synchronized(device=None):
    sess = Session(backend="host", n_nodes=1, threads_per_node=2, check=True,
                   device=device)
    counter = sess.def_global("counter", torch.tensor(0.0))
    bar = sess.barrier()

    def proc(ctx):
        # alternate turns: tid 0 updates on even rounds, tid 1 on odd ones,
        # with a barrier between rounds ordering every access pair
        for r in range(4):
            if r % 2 == ctx.tid:
                v = counter.get()
                counter.set(v + torch.tensor(ctx.tid + 1.0, device=ctx.device))
            bar.enter()
        return None

    sess.run(proc)
    findings = sess.findings()
    print(f"synchronized program: {len(findings)} finding(s)")
    sess.checker.disable()
    return findings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the session lives (default: the card)")
    args = ap.parse_args(argv)
    racy_findings = racy(args.device)
    clean_findings = synchronized(args.device)
    assert racy_findings, "the seeded race must be detected"
    assert {f.kind for f in racy_findings} == {"read-write", "write-write"}
    assert any(len(f.sites) >= 2 for f in racy_findings), \
        "both access sites must be reported"
    assert not clean_findings, "the barrier-ordered program must be clean"
    print("ok: race flagged with both sites; synchronized variant clean")
    return racy_findings


if __name__ == "__main__":
    main()
