"""Length-prefixed pickle RPC for the parameter-server runtime, the port of
``paddle_tpu/distributed/ps/rpc.py`` (reference: the brpc services under
paddle/fluid/distributed/ps/service/ — brpc_ps_server.cc,
brpc_ps_client.cc). The PS data path lives on host CPUs, as in the
reference; here it rides plain sockets with numpy payloads instead of
brpc + proto, and the card's compute path never touches it. Payloads are
unpickled, so a server listens only to the job's own processes."""
from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading

_LEN = struct.Struct("!Q")


def _send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


class RpcServer:
    """Threaded request/response server: handler(method, kwargs) ->
    result. Runs until .stop()."""

    def __init__(self, host: str, port: int, handler):
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        method, kwargs = _recv_msg(self.request)
                        if method == "__stop__":
                            _send_msg(self.request, ("ok", None))
                            outer._server.shutdown()
                            return
                        try:
                            result = outer._handler(method, kwargs)
                            _send_msg(self.request, ("ok", result))
                        except Exception as e:  # propagate to caller
                            _send_msg(self.request, ("err", repr(e)))
                except (ConnectionError, OSError):
                    return

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._handler = handler
        self._server = _Server((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def wait(self):
        self._thread.join()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


class RpcClient:
    """One persistent connection per endpoint; thread-safe via lock."""

    def __init__(self, endpoint: str):
        host, port = endpoint.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=120)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def call(self, method: str, **kwargs):
        with self._lock:
            _send_msg(self._sock, (method, kwargs))
            status, result = _recv_msg(self._sock)
        if status == "err":
            raise RuntimeError(f"ps rpc {method} failed: {result}")
        return result

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
