"""Minimal stdlib HTTP client for the inference server (counterpart of
``rdst_tpu/serving/client.py``).

Predictor-compatible: the same ``predict(x, scale)`` contract as
``LiveModel``.
"""

from __future__ import annotations

import io
import json
import urllib.request

import numpy as np


class SRClient:
    def __init__(self, base_url: str, timeout: float = 600.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    def health(self) -> dict:
        with urllib.request.urlopen(f"{self.base}/healthz",
                                    timeout=self.timeout) as r:
            return json.load(r)

    def metadata(self) -> dict:
        with urllib.request.urlopen(f"{self.base}/v1/metadata",
                                    timeout=self.timeout) as r:
            return json.load(r)

    def predict(self, x, scale: float) -> np.ndarray:
        buf = io.BytesIO()
        np.save(buf, np.asarray(x, np.float32))
        req = urllib.request.Request(
            f"{self.base}/v1/predict?scale={float(scale)}",
            data=buf.getvalue(), method="POST",
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return np.load(io.BytesIO(r.read()))
