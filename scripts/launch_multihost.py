#!/usr/bin/env python
"""Multi-process launcher — the framework's `mpirun` equivalent.

Counterpart of the reference's MPI launch layer
(ref: scripts/modal_mpi.py:29-88 spawns `mpirun -np N ./output.bin`;
scripts/local_mpi.sh:58-60 does the same locally). Here each "rank" is a
python process that joins a jax.distributed cluster via a local
coordinator; the example's `_common.bootstrap()` picks the CFA_* env vars
up (the NCCL-unique-id broadcast of init_mpi_nccl, ref: nccl_utils.h:42,
becomes the coordinator address handshake).

Usage:
    python scripts/launch_multihost.py -np 2 examples/01_ppermute_verify.py
    python scripts/launch_multihost.py -np 4 --gpus examples/04_ring_attention.py

By default each process exposes `--devices-per-proc` virtual CPU
devices. With `--gpus` each process gets exactly one card of the host
(CUDA_VISIBLE_DEVICES = its process id), since a JAX process reserves
most of every card it can see. One process driving all cards of a host
needs no launcher at all.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-np", type=int, default=2, help="number of processes")
    ap.add_argument("--devices-per-proc", type=int, default=1,
                    help="virtual CPU devices per process")
    ap.add_argument("--gpus", action="store_true",
                    help="one GPU per process instead of CPU devices")
    ap.add_argument("script", help="example/test script to launch")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    opts = ap.parse_args()

    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for pid in range(opts.np):
        env = dict(os.environ)
        env.update({
            "CFA_COORD": coord,
            "CFA_NPROC": str(opts.np),
            "CFA_PID": str(pid),
        })
        if opts.gpus:
            env.update({"CUDA_VISIBLE_DEVICES": str(pid),
                        "JAX_PLATFORMS": "cuda"})
        else:
            # each process exposes its own virtual CPU devices; the
            # global mesh spans np * devices_per_proc devices
            env.update({
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": (env.get("XLA_FLAGS", "") +
                              " --xla_force_host_platform_device_count="
                              f"{opts.devices_per_proc}").strip(),
            })
        p = subprocess.Popen(
            [sys.executable, opts.script, *opts.args], env=env,
            stdout=None if pid == 0 else subprocess.DEVNULL,
            stderr=None if pid == 0 else subprocess.STDOUT,
        )
        procs.append(p)

    rc = 0
    for pid, p in enumerate(procs):
        code = p.wait()
        if code != 0:
            print(f"[launch_multihost] rank {pid} exited {code}",
                  file=sys.stderr)
            rc = rc or code
    return rc


if __name__ == "__main__":
    sys.exit(main())
