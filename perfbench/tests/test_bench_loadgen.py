"""The load generator: closed loops over one shared list of requests,
client-side times."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from perfbench import loadgen


class _Echo(BaseHTTPRequestHandler):
    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(0.01)
        status = 500 if json.loads(body).get("fail") else 200
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_closed_loop_clients_take_the_requests_in_order():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        requests = [["/x", json.dumps({"i": i, "fail": i == 3})]
                    for i in range(200)]
        job = {"url": f"http://127.0.0.1:{httpd.server_address[1]}",
               "clients": 3, "requests": requests,
               "seconds": 0.5, "timeout": 10}
        records = loadgen.run(job, time.monotonic())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert records
    by_client = {}
    for i, cid, t_send, t_done, status, text in records:
        assert json.loads(text)["i"] == i
        assert status == (500 if i == 3 else 200)
        assert t_done > t_send
        by_client.setdefault(cid, []).append((t_send, t_done))
    for spans in by_client.values():
        spans.sort()
        for (_, done), (nxt, _) in zip(spans, spans[1:]):
            assert nxt >= done          # the next is sent after a return
    # Every client took some; each request was sent once, in list order.
    assert len(by_client) == 3
    sent = sorted(r[0] for r in records)
    assert sent == list(range(len(sent)))
