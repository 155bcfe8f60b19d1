"""Client authentication.

Re-implements the reference's client-auth providers:
  * TrustClientAuth — accept everything (auth/client_auth_trust.cc)
  * LegacyClientAuth — HMAC-signed auth tokens
    (auth/client_auth_legacy.cc + util/web/SecureCookie.cc:78-121):

      token = base64(payload) "|" created_us "|PLAIN||" hex(hmac)
      hmac  = HMAC-SHA1(secret, everything up to and incl. the last "|")

    payload is a LegacyAuthTokenData protobuf (db_namespace=1,
    userid=2 — client_auth_legacy_protos.proto).
"""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class Session:
    effective_namespace: str = ""
    user_id: str = ""
    auth_token: str = ""


class AuthError(Exception):
    pass


class TrustClientAuth:
    """Accept any client (reference: client_auth_trust.cc — assigns the
    default namespace)."""

    def __init__(self, default_namespace: str = ""):
        self.default_namespace = default_namespace

    def authenticate(self, auth_data: Dict[str, str]) -> Session:
        return Session(
            effective_namespace=auth_data.get(
                "database", self.default_namespace
            ),
            user_id=auth_data.get("user", "anonymous"),
        )


# -- minimal protobuf codec for LegacyAuthTokenData -------------------------


def _pb_encode_string(field_no: int, s: bytes) -> bytes:
    tag = (field_no << 3) | 2
    out = bytearray([tag])
    n = len(s)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | 0x80 if n else b)
        if not n:
            break
    return bytes(out) + s


def encode_token_data(db_namespace: str, userid: str) -> bytes:
    return _pb_encode_string(1, db_namespace.encode()) + _pb_encode_string(
        2, userid.encode()
    )


def decode_token_data(data: bytes) -> Tuple[str, str]:
    pos = 0
    fields = {}
    while pos < len(data):
        tag = data[pos]
        pos += 1
        field_no, wire = tag >> 3, tag & 7
        if wire == 2:
            n = 0
            shift = 0
            while True:
                b = data[pos]
                pos += 1
                n |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            fields[field_no] = data[pos : pos + n]
            pos += n
        elif wire == 0:
            while data[pos] & 0x80:
                pos += 1
            pos += 1
        else:
            break
    return (
        fields.get(1, b"").decode(),
        fields.get(2, b"").decode(),
    )


# -- secure cookie ----------------------------------------------------------


class SecureCookieCoder:
    """HMAC-SHA1 signed cookies (util/web/SecureCookie.cc)."""

    def __init__(self, secret: str, expire_after_days: float = 365.0):
        self.secret = secret.encode()
        self.expire_us = int(expire_after_days * 86400 * 1e6)

    def encode(self, payload: bytes, created_us: Optional[int] = None) -> str:
        if created_us is None:
            created_us = int(time.time() * 1e6)
        prefix = (
            base64.b64encode(payload).decode()
            + "|"
            + str(created_us)
            + "|PLAIN||"
        )
        sig = hmac_mod.new(self.secret, prefix.encode(), hashlib.sha1)
        return prefix + sig.hexdigest()

    def decode_and_verify(self, token: str) -> Optional[bytes]:
        parts = token.split("|")
        if len(parts) != 5:
            return None
        prefix = token[: token.rfind("|") + 1]
        expect = hmac_mod.new(
            self.secret, prefix.encode(), hashlib.sha1
        ).hexdigest()
        if not hmac_mod.compare_digest(expect, parts[4]):
            return None
        if parts[2] != "PLAIN":
            return None
        try:
            created_us = int(parts[1])
        except ValueError:
            return None
        now = int(time.time() * 1e6)
        if created_us < now and (now - created_us) > self.expire_us:
            return None
        return base64.b64decode(parts[0])


class LegacyClientAuth:
    """Token auth (reference: client_auth_legacy.cc:32-52)."""

    def __init__(self, secret: str):
        self.coder = SecureCookieCoder(secret)

    def authenticate(self, auth_data: Dict[str, str]) -> Session:
        token = auth_data.get("auth_token", "")
        if not token:
            raise AuthError("missing auth token")
        payload = self.coder.decode_and_verify(token)
        if payload is None:
            raise AuthError("invalid auth token")
        db_namespace, userid = decode_token_data(payload)
        return Session(
            effective_namespace=db_namespace,
            user_id=userid,
            auth_token=token,
        )

    def make_token(self, db_namespace: str, userid: str) -> str:
        """Mint a signed token (the reference's tokens come from an
        external issuer sharing the secret)."""
        return self.coder.encode(encode_token_data(db_namespace, userid))
