"""Managed-platform / serverless entry point (counterpart of
`mcos_tpu/api/serverless.py`).

- The CUDA kernels' build directory goes under $MCOS_JIT_CACHE (default
  mcos_tpu_jit in the temporary directory, /tmp unless $TMPDIR says
  otherwise), since a serverless filesystem is read-only outside /tmp:
  the first process on an instance builds, later ones load
  (`utils/checkpoint.py:enable_compilation_cache`).
- `app` is the ASGI application when fastapi is installed, and
  `serve_wsgi` runs the stdlib transport on $PORT for platforms that just
  exec a process. Both price on the device in $MCOS_DEVICE (default
  cuda).

Usage:
    # Any ASGI platform (fastapi + uvicorn in the image):
    uvicorn mcos_tpu_torch.api.serverless:app --host 0.0.0.0 --port $PORT

    # Process-exec platforms (stdlib only):
    python -m mcos_tpu_torch.api.serverless
"""

from __future__ import annotations

import os
import tempfile

from mcos_tpu_torch.utils.checkpoint import enable_compilation_cache

enable_compilation_cache(os.environ.get(
    "MCOS_JIT_CACHE", os.path.join(tempfile.gettempdir(), "mcos_tpu_jit")))

DEVICE = os.environ.get("MCOS_DEVICE", "cuda")


def _make_app():
    try:
        from mcos_tpu_torch.api.server import create_fastapi_app

        return create_fastapi_app(device=DEVICE)
    except ImportError:
        return None


#: ASGI application (None when fastapi is absent: use `serve_wsgi` then).
app = _make_app()


def serve_wsgi() -> None:
    """Stdlib fallback: resident ThreadingHTTPServer on $PORT."""
    from mcos_tpu_torch.api.server import serve

    port = int(os.environ.get("PORT", "8000"))
    serve(host="0.0.0.0", port=port, device=DEVICE).serve_forever()


if __name__ == "__main__":
    serve_wsgi()
