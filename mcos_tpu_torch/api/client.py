"""Python client for the HTTP API of `mcos_tpu_torch.api.server`
(counterpart of `mcos_tpu/api/client.py`, copied; the two servers answer
the same routes, so either client talks to either server).

Zero dependencies (urllib), one method per endpoint, uniform error
mapping: HTTP 4xx/5xx raise `ApiClientError` carrying the server's
`detail` payload (guard failures arrive structured, not as strings).

    from mcos_tpu_torch.api.client import McosClient
    c = McosClient("http://localhost:8000")
    c.price(spot=22500, strike=22500, T=0.1)["price"]
    c.greeks(spot=22500, T=0.1, strikes=[22000, 22500, 23000])["chain"]

Every POST method accepts arbitrary extra keyword fields and passes them
through verbatim, so new server-side request fields never require a client
upgrade.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional


class ApiClientError(Exception):
    """HTTP-level failure; `.status` and `.detail` mirror the response."""

    def __init__(self, status: int, detail):
        super().__init__(f"HTTP {status}: {detail}")
        self.status = status
        self.detail = detail


class McosClient:
    def __init__(self, url: str = "http://localhost:8000",
                 timeout: float = 600.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    # -- transport ---------------------------------------------------------
    def _request(self, path: str, body: Optional[dict] = None,
                 query: Optional[dict] = None) -> dict:
        url = self.url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            url, data=data,
            headers={"Content-Type": "application/json"} if body is not None
            else {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("detail")
            except Exception:  # noqa: BLE001 — non-JSON error body
                detail = e.reason
            raise ApiClientError(e.code, detail) from None

    def _post(self, path: str, **fields) -> dict:
        body = {k: v for k, v in fields.items() if v is not None}
        return self._request(path, body=body)

    # -- GET ---------------------------------------------------------------
    def health(self) -> dict:
        return self._request("/api/health")

    def metrics(self) -> dict:
        return self._request("/api/metrics")

    def quote(self, symbol: str) -> dict:
        return self._request("/api/quote", query={"symbol": symbol})

    def symbols(self, q: str = "") -> dict:
        return self._request("/api/symbols", query={"q": q} if q else None)

    # -- pricing / risk ----------------------------------------------------
    def price(self, **kw) -> dict:
        return self._post("/api/price", **kw)

    def greeks(self, **kw) -> dict:
        return self._post("/api/greeks", **kw)

    def stress(self, **kw) -> dict:
        return self._post("/api/stress", **kw)

    def regime(self, **kw) -> dict:
        return self._post("/api/regime", **kw)

    def hedge(self, **kw) -> dict:
        return self._post("/api/hedge", **kw)

    def smile(self, **kw) -> dict:
        return self._post("/api/smile", **kw)

    def convergence(self, **kw) -> dict:
        return self._post("/api/convergence", **kw)

    def exotic(self, **kw) -> dict:
        return self._post("/api/exotic", **kw)

    def american(self, **kw) -> dict:
        return self._post("/api/american", **kw)

    def book(self, **kw) -> dict:
        return self._post("/api/book", **kw)

    def basket(self, **kw) -> dict:
        return self._post("/api/basket", **kw)

    def calibrate(self, **kw) -> dict:
        return self._post("/api/calibrate", **kw)

    def surface(self, **kw) -> dict:
        return self._post("/api/surface", **kw)

    def localvol(self, **kw) -> dict:
        return self._post("/api/localvol", **kw)

    def cliquet(self, **kw) -> dict:
        return self._post("/api/cliquet", **kw)

    def slv(self, **kw) -> dict:
        return self._post("/api/slv", **kw)

    def modelrisk(self, **kw) -> dict:
        return self._post("/api/modelrisk", **kw)

    def pnl(self, **kw) -> dict:
        return self._post("/api/pnl", **kw)

    def quanto(self, **kw) -> dict:
        return self._post("/api/quanto", **kw)

    def autocall(self, **kw) -> dict:
        return self._post("/api/autocall", **kw)

    def hhw(self, **kw) -> dict:
        return self._post("/api/hhw", **kw)

    def exposure(self, **kw) -> dict:
        return self._post("/api/exposure", **kw)

    def rough(self, **kw) -> dict:
        return self._post("/api/rough", **kw)

    def var(self, **kw) -> dict:
        return self._post("/api/var", **kw)

    def svcj(self, **kw) -> dict:
        return self._post("/api/svcj", **kw)

    def termsvj(self, **kw) -> dict:
        return self._post("/api/termsvj", **kw)

    def volderivs(self, **kw) -> dict:
        return self._post("/api/volderivs", **kw)

    def margin(self, **kw) -> dict:
        return self._post("/api/margin", **kw)

    def replicate(self, **kw) -> dict:
        return self._post("/api/replicate", **kw)

    def pde(self, **kw) -> dict:
        return self._post("/api/pde", **kw)

    def quotegreeks(self, **kw) -> dict:
        return self._post("/api/quotegreeks", **kw)

    def roughheston(self, **kw) -> dict:
        return self._post("/api/roughheston", **kw)
