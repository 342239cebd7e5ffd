"""Start N gloo ranks of a worker script and wait for them.

Every multi-rank port test goes through here.  The ranks rendezvous
through a ``file://`` store in a directory the test owns (its
``tmp_path``), so no TCP port is picked, released and then raced for by
another process; gloo is pinned to the loopback interface
(``GLOO_SOCKET_IFNAME=lo``), so its pairs connect on 127.0.0.1 whatever
the host's name resolves to.  A rank's checks run once: nothing here
retries them.

In the test::

    logs = torch_launch.run(
        lambda rank, init: [WORKER, rank, 2, init, out(rank), "mode"],
        world=2, tmp_dir=tmp_path, timeout=240)

and in the rank (``init`` is the third argument)::

    torch_launch.init_process_group(init, world, rank)
"""
from __future__ import annotations

import itertools
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

#: the interface gloo's pairs use
LOOPBACK = "lo"
_seq = itertools.count()


def rendezvous(tmp_dir) -> str:
    """A fresh ``file://`` init method in ``tmp_dir`` (the store's file
    must not exist before the ranks start)."""
    path = os.path.join(str(tmp_dir),
                        f"rendezvous-{os.getpid()}-{next(_seq)}")
    if os.path.exists(path):
        os.remove(path)
    return "file://" + path


def rank_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of a rank: this process's, gloo on the loopback
    interface, ``AUTODIST_IS_TESTING`` (one facade per process is the
    default), then ``extra`` (a None value removes its variable)."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME=LOOPBACK,
               AUTODIST_IS_TESTING="True")
    for key, value in (extra or {}).items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = value
    return env


class Launch:
    """``world`` ranks started at once: ``argv(rank, init)`` gives the
    arguments after the interpreter (each turned into a string)."""

    def __init__(self, argv: Callable[[int, str], Sequence], world: int,
                 tmp_dir, env: Optional[Dict[str, str]] = None):
        self.world = world
        self.init = rendezvous(tmp_dir)
        self.procs = [subprocess.Popen(
            [sys.executable] + [str(a) for a in argv(rank, self.init)],
            env=rank_env(env), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(world)]

    def wait(self, timeout: float) -> List[str]:
        """Each rank's log once all have exited within ``timeout``
        seconds; asserts that every rank exited 0."""
        deadline = time.monotonic() + timeout
        try:
            logs = [p.communicate(timeout=max(deadline - time.monotonic(),
                                              1.0))[0] for p in self.procs]
        finally:
            self.kill()
        assert [p.returncode for p in self.procs] == [0] * self.world, \
            "\n".join(logs)
        return logs

    def kill(self) -> None:
        """Stop every rank still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def run(argv: Callable[[int, str], Sequence], world: int, tmp_dir,
        timeout: float, env: Optional[Dict[str, str]] = None) -> List[str]:
    """Start the ranks and wait for them (:class:`Launch`)."""
    return Launch(argv, world, tmp_dir, env).wait(timeout)


def init_process_group(init: str, world: int, rank: int) -> None:
    """Join the gloo group of a launch from inside a rank."""
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", LOOPBACK)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
