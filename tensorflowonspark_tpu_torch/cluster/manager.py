"""Per-node IPC manager: named queues + a KV store, reachable over TCP.

Reference parity: ``tensorflowonspark/TFManager.py`` (``start``, ``connect``,
proxies ``get_queue``/``get``/``set``, modes ``'local'``/``'remote'``).

Design difference from the reference (deliberate, TPU-first): the reference
started the manager in a *separate* server process (fork) and both the
Spark task and the TF child paid pickle-proxy cost per queue op — SURVEY.md
§3.2 flags that as the dominant overhead. Here the manager server runs as a
*thread inside the node process that owns the training loop*, so the
consumer (`DataFeed`) reads plain in-process queues with zero IPC; only
remote producers (feeder tasks / the driver) pay the proxy cost, and they
amortize it by putting whole batches per call.

``mode='local'`` binds loopback only; ``mode='remote'`` binds all
interfaces (needed when the driver on another host feeds this node).
"""

from __future__ import annotations

import logging
import queue
import threading
from multiprocessing.managers import BaseManager
from typing import Any, Iterable

logger = logging.getLogger(__name__)

DEFAULT_QUEUES = ("input", "output", "error", "control")
DEFAULT_MAXSIZE = 1024


class _ManagerBase(BaseManager):
    """Registry holder; per-call subclasses bind instance state."""


class ManagerHandle:
    """Uniform handle over a local (in-process) or remote (proxied) manager.

    API parity with the reference's manager usage:
    ``get_queue(qname)`` → queue-like with put/get/task_done/join;
    ``get(key)`` / ``set(key, value)`` → KV store (holds ``'state'``:
    ``'running'`` | ``'terminating'`` | ``'stopped'``).
    """

    def __init__(
        self,
        *,
        address: tuple[str, int],
        authkey: bytes,
        qdict: dict[str, queue.Queue] | None = None,
        kdict: dict[str, Any] | None = None,
        remote_mgr: BaseManager | None = None,
        server: object | None = None,
    ):
        self.address = address
        self._authkey = authkey
        self._qdict = qdict
        self._kdict = kdict
        self._remote = remote_mgr
        self._server = server

    @property
    def is_local(self) -> bool:
        return self._qdict is not None

    def get_queue(self, qname: str):
        if self._qdict is not None:
            return self._qdict[qname]
        return self._remote.get_queue(qname)  # type: ignore[union-attr]

    def get(self, key: str) -> Any:
        if self._kdict is not None:
            return self._kdict.get(key)
        return self._remote.get_kv().get(key)  # type: ignore[union-attr]

    def set(self, key: str, value: Any) -> None:
        if self._kdict is not None:
            self._kdict[key] = value
        else:
            self._remote.get_kv().update({key: value})  # type: ignore[union-attr]

    def stop(self) -> None:
        """Stop the server thread and release its port (local handles only).

        ``Server.serve_forever`` installs a *fresh* ``stop_event`` when the
        thread starts, so the event must be read off the server at stop
        time, not captured at start.
        """
        if self._server is None:
            return
        stop_event = getattr(self._server, "stop_event", None)
        if stop_event is not None:
            stop_event.set()
        listener = getattr(self._server, "listener", None)
        if listener is not None:
            # multiprocessing's accepter loop retries a failed accept() at
            # once, and a closed listener fails every time: the first
            # connection attempt after the close would spin it at 100 % CPU
            # for the life of the process. Park it on a listener that never
            # returns, then release the port.
            self._server.listener = _ParkedListener()
            try:
                listener.close()
            except OSError:
                pass


class _ParkedListener:
    """Stands in for a stopped server's listener: ``accept`` never returns."""

    _never = threading.Event()

    def accept(self):
        self._never.wait()


def start(
    authkey: bytes,
    queues: Iterable[str] = DEFAULT_QUEUES,
    mode: str = "local",
    maxsize: int = DEFAULT_MAXSIZE,
) -> ManagerHandle:
    """Start a manager server thread in this process; return a local handle.

    Reference: ``TFManager.py:start``. The returned handle's ``address`` and
    the ``authkey`` are what remote producers need for :func:`connect`; the
    node registers them with the reservation server.
    """
    qdict: dict[str, queue.Queue] = {
        name: queue.Queue(maxsize=maxsize) for name in queues
    }
    kdict: dict[str, Any] = {"state": "running"}

    class _Mgr(_ManagerBase):
        pass

    # Registered callables run in server worker threads of THIS process and
    # close over qdict/kdict directly; BaseManager returns proxies to callers.
    _Mgr.register("get_queue", callable=lambda qname: qdict[qname])
    _Mgr.register("get_kv", callable=lambda: kdict)

    host = "127.0.0.1" if mode == "local" else ""
    mgr = _Mgr(address=(host, 0), authkey=authkey)
    server = mgr.get_server()

    thread = threading.Thread(
        target=server.serve_forever, name="tfmanager-server", daemon=True
    )
    thread.start()

    addr = server.address
    advertised = addr[0]
    if advertised in ("", "0.0.0.0"):
        from tensorflowonspark_tpu_torch.utils.util import get_ip_address

        advertised = get_ip_address()
    logger.info("manager serving on %s:%d (mode=%s)", advertised, addr[1], mode)
    return ManagerHandle(
        address=(advertised, addr[1]),
        authkey=authkey,
        qdict=qdict,
        kdict=kdict,
        server=server,
    )


def connect(address: tuple[str, int] | list, authkey: bytes) -> ManagerHandle:
    """Connect to a manager started elsewhere; return a remote handle.

    Reference: ``TFManager.py:connect``. Queue operations on the returned
    handle are proxied over TCP — producers should put *batches*, not items.
    """

    class _Mgr(_ManagerBase):
        pass

    _Mgr.register("get_queue")
    _Mgr.register("get_kv")
    mgr = _Mgr(address=(address[0], int(address[1])), authkey=authkey)
    mgr.connect()
    return ManagerHandle(
        address=(address[0], int(address[1])), authkey=authkey, remote_mgr=mgr
    )
