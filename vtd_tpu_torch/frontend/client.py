"""HTTP API client (port of ``vtd_tpu/frontend/client.py``).

Method-parity with the reference frontend's ``APIClient``
(reference ``app/frontend/main.py:22-136``): login, register,
upload_video, get_videos, start_processing, get_job_status, get_results
— implemented on urllib (requests is not a dependency), and extended
with cancel_job / wait_for_job. Requests go through urllib's default
opener, so the ``*_proxy`` / ``no_proxy`` environment variables apply
as they do to any urllib caller.
"""
from __future__ import annotations

import json
import mimetypes
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Any, Dict, List, Optional, Tuple


class APIClient:
    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.token: Optional[str] = None
        self.timeout = timeout

    # ------------------------------------------------------------------
    def _request(
        self,
        method: str,
        path: str,
        *,
        params: Optional[Dict[str, Any]] = None,
        json_body: Any = None,
        form: Optional[Dict[str, str]] = None,
        files: Optional[Dict[str, Tuple[str, bytes]]] = None,
    ) -> Tuple[int, Any]:
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        headers = self.get_headers()
        data = None
        if json_body is not None:
            data = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        elif files is not None:
            boundary = uuid.uuid4().hex
            parts = []
            for k, v in (form or {}).items():
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; '
                    f'name="{k}"\r\n\r\n{v}\r\n'.encode()
                )
            for k, (fname, fdata) in files.items():
                ctype = (
                    mimetypes.guess_type(fname)[0]
                    or "application/octet-stream"
                )
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; '
                    f'name="{k}"; filename="{fname}"\r\n'
                    f"Content-Type: {ctype}\r\n\r\n".encode()
                    + fdata + b"\r\n"
                )
            parts.append(f"--{boundary}--\r\n".encode())
            data = b"".join(parts)
            headers["Content-Type"] = (
                f"multipart/form-data; boundary={boundary}"
            )
        elif form is not None:
            data = urllib.parse.urlencode(form).encode()
            headers["Content-Type"] = "application/x-www-form-urlencoded"

        req = urllib.request.Request(
            url, data=data, headers=headers, method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = resp.read()
                status = resp.status
        except urllib.error.HTTPError as e:
            body = e.read()
            status = e.code
        try:
            return status, json.loads(body)
        except ValueError:
            return status, body

    def get_headers(self) -> Dict[str, str]:
        return {"Authorization": f"Bearer {self.token}"} if self.token else {}

    # ------------------------------------------------------------------
    def login(self, username: str, password: str) -> bool:
        status, body = self._request(
            "POST", "/api/v1/auth/login",
            form={"username": username, "password": password},
        )
        if status == 200:
            self.token = body["access_token"]
            return True
        return False

    def register(self, email: str, username: str, password: str) -> bool:
        status, body = self._request(
            "POST", "/api/v1/auth/register",
            json_body={
                "email": email, "username": username, "password": password,
            },
        )
        if status == 201:
            self.token = body["access_token"]
            return True
        return False

    def upload_video(
        self, filename: str, content: bytes, category: Optional[str] = None
    ) -> Optional[Dict]:
        status, body = self._request(
            "POST", "/api/v1/videos/upload",
            files={"file": (filename, content)},
            form={"category": category} if category else {},
        )
        return body if status == 201 else None

    def get_videos(self) -> List[Dict]:
        status, body = self._request("GET", "/api/v1/videos/")
        return body if status == 200 else []

    def start_processing(
        self,
        video_id: int,
        confidence: float = 0.5,
        use_transformer: bool = True,
        sample_mode: str = "stride",
        temporal_dedup: bool = False,
    ) -> Optional[Dict]:
        status, body = self._request(
            "POST", f"/api/v1/processing/videos/{video_id}/detect",
            params={
                "confidence_threshold": confidence,
                "use_transformer": str(use_transformer).lower(),
                "sample_mode": sample_mode,
                "temporal_dedup": str(temporal_dedup).lower(),
            },
        )
        return body if status == 200 else None

    def get_job_status(self, job_id: int) -> Optional[Dict]:
        status, body = self._request(
            "GET", f"/api/v1/processing/jobs/{job_id}/status"
        )
        return body if status == 200 else None

    def cancel_job(self, job_id: int) -> bool:
        status, _ = self._request(
            "POST", f"/api/v1/processing/jobs/{job_id}/cancel"
        )
        return status == 200

    def get_results(self, video_id: int, format: str = "json") -> Optional[Dict]:
        status, body = self._request(
            "GET", f"/api/v1/processing/videos/{video_id}/results",
            params={"format": format},
        )
        return body if status == 200 else None

    def wait_for_job(
        self, job_id: int, timeout: float = 600, poll: float = 2.0
    ) -> Optional[Dict]:
        """Poll until the job reaches a terminal state (the reference UI
        polls every 2 s, frontend/main.py:294-322)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            status = self.get_job_status(job_id)
            if status and status.get("status") in (
                "completed", "failed", "cancelled",
            ):
                return status
            time.sleep(poll)
        return None
