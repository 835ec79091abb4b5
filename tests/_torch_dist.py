"""A torch.distributed world for the port's tests: each world runs in a
subprocess of its own (as ``tests/test_launch_mesh.py`` runs JAX's
multi-device cases), so no test process ever holds a process group."""
import os
import socket
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def env() -> dict:
    e = dict(os.environ)
    e["PYTHONPATH"] = SRC + os.pathsep + e.get("PYTHONPATH", "")
    e["OMP_NUM_THREADS"] = "1"
    e.pop("XLA_FLAGS", None)
    return e


def run(args, timeout=240) -> str:
    """Run ``args`` (a command) → its stdout; fails the test on a non-zero
    exit with the command's stderr."""
    out = subprocess.run(args, env=env(), capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    return out.stdout


def gloo_world(n: int, body: str, tmp_path, timeout=240) -> str:
    """Run ``body``, the source of ``work(rank, n, out_dir)``, on each of
    ``n`` gloo ranks on this host (``tcp://localhost``) → rank 0's
    stdout. ``out_dir`` is ``tmp_path``."""
    script = tmp_path / "world.py"
    script.write_text(textwrap.dedent(body) + textwrap.dedent(f"""

        def _main(rank):
            import torch.distributed as dist
            dist.init_process_group(
                "gloo", init_method="tcp://localhost:{free_port()}",
                rank=rank, world_size={n})
            try:
                work(rank, {n}, {str(tmp_path)!r})
                # every rank done before any tears its groups down
                dist.barrier()
            finally:
                dist.destroy_process_group()


        if __name__ == "__main__":
            import torch.multiprocessing as mp
            mp.spawn(_main, nprocs={n})
        """))
    return run([sys.executable, str(script)], timeout)
