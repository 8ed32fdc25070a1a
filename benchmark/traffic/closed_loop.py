"""Closed loop: ``clients`` threads, each with one keep-alive connection,
each sending its next request as soon as its last one is answered.  A
request's latency runs from its send, which in a closed loop is when it
was due.  Clients stop sending when the window closes; what they have in
flight is waited for (``grace_s``) and recorded, but counts in the
window only if it completed there."""

from __future__ import annotations

import threading
import time


def drive(mix: dict, session) -> dict:
    """``session`` gives ``request(c, k)`` (client c's k-th request),
    ``post(conn, req)`` -> (status, body bytes), ``connect()`` -> a
    connection, ``window_start``/``window_end`` (perf_counter seconds,
    set by ``session.open_window()``) and ``record(...)``."""
    clients = int(mix["clients"])
    start = threading.Barrier(clients + 1)

    def client(c: int) -> None:
        conn = session.connect()
        k = 0
        try:
            start.wait()
            while True:
                sent = time.perf_counter()
                if sent >= session.window_end:
                    return
                req = session.request(c, k)
                k += 1
                try:
                    status, body = session.post(conn, req)
                except OSError as exc:
                    status, body = -1, repr(exc).encode()
                    conn.close()
                    conn = session.connect()
                session.record(req, due=sent, sent=sent,
                               done=time.perf_counter(), status=status,
                               body=body)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"bench-client-{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    session.open_window()
    start.wait()
    session.close_window()
    deadline = session.window_end + session.grace_s
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    return {"clients": clients,
            "stuck_clients": sum(t.is_alive() for t in threads)}
