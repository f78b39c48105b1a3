"""JWT (HS256) auth, stdlib only (port of ``vtd_tpu/serve/auth.py``).

Parity with the reference's python-jose usage (reference
``app/api/endpoints/auth.py:15-50``): HS256-signed tokens with ``sub``
and ``exp`` claims, bearer extraction, and a ``get_current_user``
dependency raising 401 with a WWW-Authenticate header.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any, Dict, Optional

from ..core.config import settings
from .db import UserCRUD, get_database
from .http import HTTPException, Request


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


class JWTError(Exception):
    pass


def jwt_encode(
    payload: Dict[str, Any],
    secret: Optional[str] = None,
    algorithm: str = "HS256",
) -> str:
    if algorithm != "HS256":
        raise JWTError(f"Unsupported algorithm {algorithm}")
    secret = secret or settings.secret_key
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64url(json.dumps(payload, default=str).encode())
    signing_input = f"{header}.{body}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{body}.{_b64url(sig)}"


def jwt_decode(
    token: str,
    secret: Optional[str] = None,
    algorithms=("HS256",),
) -> Dict[str, Any]:
    secret = secret or settings.secret_key
    try:
        header_b64, body_b64, sig_b64 = token.split(".")
        signing_input = f"{header_b64}.{body_b64}".encode()
        expected = hmac.new(
            secret.encode(), signing_input, hashlib.sha256
        ).digest()
        if not hmac.compare_digest(expected, _b64url_decode(sig_b64)):
            raise JWTError("Signature verification failed")
        header = json.loads(_b64url_decode(header_b64))
        if header.get("alg") not in algorithms:
            raise JWTError("Unexpected algorithm")
        payload = json.loads(_b64url_decode(body_b64))
    except JWTError:
        raise
    except Exception as e:
        raise JWTError(f"Malformed token: {e}")
    exp = payload.get("exp")
    if exp is not None and time.time() > float(exp):
        raise JWTError("Token expired")
    return payload


def create_access_token(
    data: Dict[str, Any], expires_minutes: Optional[float] = None
) -> str:
    to_encode = dict(data)
    minutes = (
        expires_minutes
        if expires_minutes is not None
        else settings.access_token_expire_minutes
    )
    to_encode["exp"] = time.time() + minutes * 60
    return jwt_encode(to_encode)


_CREDENTIALS_EXC = lambda: HTTPException(
    401,
    "Could not validate credentials",
    headers={"WWW-Authenticate": "Bearer"},
)


def get_current_user(request: Request) -> Dict[str, Any]:
    auth = request.headers.get("authorization", "")
    if not auth.lower().startswith("bearer "):
        raise _CREDENTIALS_EXC()
    token = auth[7:].strip()
    try:
        payload = jwt_decode(token)
    except JWTError:
        raise _CREDENTIALS_EXC()
    username = payload.get("sub")
    if not username:
        raise _CREDENTIALS_EXC()
    user = UserCRUD.get_by_username(get_database(), username)
    if user is None:
        raise _CREDENTIALS_EXC()
    return user


def get_current_active_user(request: Request) -> Dict[str, Any]:
    user = get_current_user(request)
    if not user.get("is_active"):
        raise HTTPException(400, "Inactive user")
    return user
