"""Public-API authentication: password file + JWT (a copy of
trino_tpu/server/auth.py).

Reference: ``server/security/PasswordAuthenticatorManager`` + the
password-file plugin (``plugin/trino-password-authenticators``) and
``server/security/jwt/JwtAuthenticator`` — the coordinator's HTTP surface
authenticates end users (Basic or Bearer) BEFORE dispatch; the internal
control plane keeps its separate HMAC (server/wire.py). Stdlib-only
implementations: PBKDF2-SHA256 password hashes and HS256 JWTs.
"""
from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json
import time
from typing import Dict, Optional

from trino_tpu_torch.server.security import Identity


class AuthenticationError(Exception):
    pass


# ------------------------------------------------------------ password file

PBKDF2_ITERATIONS = 100_000


def hash_password(password: str, salt: Optional[bytes] = None,
                  iterations: int = PBKDF2_ITERATIONS) -> str:
    """'pbkdf2_sha256$<iters>$<salt_hex>$<hash_hex>' — the storage format
    of the password file (role of the reference's bcrypt/PBKDF2 htpasswd
    entries)."""
    import os

    salt = salt if salt is not None else os.urandom(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iterations)
    return f"pbkdf2_sha256${iterations}${salt.hex()}${dk.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        scheme, iters, salt_hex, hash_hex = stored.split("$")
        if scheme != "pbkdf2_sha256":
            return False
        dk = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), bytes.fromhex(salt_hex), int(iters))
        return hmac.compare_digest(dk.hex(), hash_hex)
    except (ValueError, binascii.Error):
        return False


class PasswordFileAuthenticator:
    """user:pbkdf2-hash lines (reference: file password authenticator)."""

    def __init__(self, entries: Dict[str, str]):
        self._entries = dict(entries)

    @classmethod
    def from_file(cls, path: str) -> "PasswordFileAuthenticator":
        entries: Dict[str, str] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                user, _, stored = line.partition(":")
                entries[user] = stored
        return cls(entries)

    def authenticate(self, user: str, password: str) -> Identity:
        stored = self._entries.get(user)
        if stored is None or not verify_password(password, stored):
            raise AuthenticationError("Invalid credentials")
        return Identity(user)


# --------------------------------------------------------------------- jwt


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def make_jwt(claims: dict, secret: bytes) -> str:
    """Mint an HS256 JWT (test/ops helper; real deployments bring their
    own token service)."""
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims).encode())
    signing = f"{header}.{payload}".encode()
    sig = _b64url(hmac.new(secret, signing, hashlib.sha256).digest())
    return f"{header}.{payload}.{sig}"


class JwtAuthenticator:
    """HS256 bearer-token validation: signature + exp + principal claim
    (reference: server/security/jwt — RS256/JWKS in the reference; the
    validation contract is the same)."""

    def __init__(self, secret: bytes, principal_claim: str = "sub"):
        self._secret = secret
        self._claim = principal_claim

    def authenticate(self, token: str) -> Identity:
        try:
            header_s, payload_s, sig_s = token.split(".")
            header = json.loads(_unb64url(header_s))
            if header.get("alg") != "HS256":
                raise AuthenticationError("unsupported JWT alg")
            signing = f"{header_s}.{payload_s}".encode()
            want = hmac.new(self._secret, signing, hashlib.sha256).digest()
            if not hmac.compare_digest(want, _unb64url(sig_s)):
                raise AuthenticationError("bad JWT signature")
            claims = json.loads(_unb64url(payload_s))
        except (ValueError, binascii.Error, json.JSONDecodeError) as e:
            raise AuthenticationError(f"malformed JWT: {e}") from e
        exp = claims.get("exp")
        if exp is not None and time.time() > float(exp):
            raise AuthenticationError("JWT expired")
        user = claims.get(self._claim)
        if not user:
            raise AuthenticationError(f"JWT missing {self._claim} claim")
        return Identity(str(user))


# ------------------------------------------------------------- http surface


class Authenticator:
    """The coordinator's request authenticator: Basic -> password file,
    Bearer -> JWT; absence of either configured scheme = open cluster
    (the reference's insecure-authentication default)."""

    def __init__(self, password: Optional[PasswordFileAuthenticator] = None,
                 jwt: Optional[JwtAuthenticator] = None):
        self.password = password
        self.jwt = jwt

    @property
    def required(self) -> bool:
        return self.password is not None or self.jwt is not None

    def authenticate_header(self, authorization: Optional[str]) -> Identity:
        """Authorization header -> Identity, or AuthenticationError."""
        if not self.required:
            raise AuthenticationError("no authenticator configured")
        if not authorization:
            raise AuthenticationError("Authorization header required")
        scheme, _, rest = authorization.partition(" ")
        scheme = scheme.lower()
        if scheme == "basic" and self.password is not None:
            try:
                user, _, pw = base64.b64decode(rest).decode().partition(":")
            except (ValueError, binascii.Error) as e:
                raise AuthenticationError("malformed Basic credentials") from e
            return self.password.authenticate(user, pw)
        if scheme == "bearer" and self.jwt is not None:
            return self.jwt.authenticate(rest.strip())
        raise AuthenticationError(f"unsupported authorization scheme {scheme}")
