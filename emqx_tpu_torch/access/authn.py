"""Authentication chains — parity with
``apps/emqx/src/emqx_authentication.erl`` + ``apps/emqx_authn``.

A chain is an ordered list of providers; each provider's
``authenticate(credential)`` returns:

- ``("ok", extras)``      → accepted, stop the chain (extras may carry
                            ``is_superuser``, ``acl`` …)
- ``"ignore"``            → not my user / backend unsure, try next
- ``("error", rc)``       → rejected, stop the chain

mirroring the provider behaviour `-callback authenticate/2`
(emqx_authentication.erl:161) and the chain fold (:244-283). An empty
chain allows everyone (anonymous), as the reference does with no
authenticators configured.

Providers implemented (apps/emqx_authn/src/simple_authn/):
``BuiltinDbProvider`` (password_based:built_in_database),
``JwtProvider`` (HS256/HS384/HS512 over stdlib hmac),
``HttpProvider`` (password_based:http, pluggable request fn so tests
inject a fake server), ``ScramProvider`` (SCRAM-SHA-256 first/final
message flow used by MQTT5 enhanced auth).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from emqx_tpu_torch.access import hashing
from emqx_tpu_torch.access.hashing import (
    HashSpec, check_password, gen_salt, hash_password,
)

Credential = dict  # clientid/username/password/peername/...


class Provider:
    """Provider behaviour (emqx_authentication.erl:161)."""

    id: str = "provider"

    def authenticate(self, cred: Credential):
        raise NotImplementedError

    def destroy(self) -> None:
        pass


# -- built-in password database ------------------------------------------


@dataclass
class _UserRow:
    key: str
    stored: bytes
    salt: bytes
    is_superuser: bool = False


class BuiltinDbProvider(Provider):
    """In-memory user DB keyed by username or clientid
    (emqx_authn_mnesia.erl)."""

    id = "password_based:built_in_database"

    def __init__(self, user_id_type: str = "username",
                 hash_spec: Optional[HashSpec] = None) -> None:
        self.user_id_type = user_id_type          # username | clientid
        self.hash_spec = hash_spec or HashSpec()
        hashing.warm(self.hash_spec)
        self._users: dict[str, _UserRow] = {}

    def add_user(self, user_id: str, password: str,
                 is_superuser: bool = False) -> None:
        salt = gen_salt(self.hash_spec)
        stored = hash_password(self.hash_spec, salt, password.encode())
        self._users[user_id] = _UserRow(user_id, stored, salt, is_superuser)

    def delete_user(self, user_id: str) -> bool:
        return self._users.pop(user_id, None) is not None

    def lookup_user(self, user_id: str) -> Optional[dict]:
        row = self._users.get(user_id)
        if row is None:
            return None
        return {"user_id": row.key, "is_superuser": row.is_superuser}

    def list_users(self) -> list[dict]:
        return [{"user_id": r.key, "is_superuser": r.is_superuser}
                for r in self._users.values()]

    def authenticate(self, cred: Credential):
        user_id = cred.get(self.user_id_type)
        if not user_id:
            return "ignore"
        row = self._users.get(user_id)
        if row is None:
            return "ignore"                      # not my user → next provider
        password = cred.get("password") or b""
        if isinstance(password, str):
            password = password.encode()
        if check_password(self.hash_spec, row.salt, row.stored, password):
            return ("ok", {"is_superuser": row.is_superuser})
        return ("error", "bad_username_or_password")


# -- JWT ------------------------------------------------------------------


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _unb64url(data: str) -> bytes:
    pad = -len(data) % 4
    return base64.urlsafe_b64decode(data + "=" * pad)


def jwt_sign(claims: dict, secret: bytes, alg: str = "HS256") -> str:
    """Test/tooling helper: mint an HS* JWT."""
    digest = {"HS256": "sha256", "HS384": "sha384", "HS512": "sha512"}[alg]
    header = _b64url(json.dumps({"alg": alg, "typ": "JWT"}).encode())
    body = _b64url(json.dumps(claims).encode())
    sig = _b64url(hmac.new(secret, header + b"." + body,
                           getattr(hashlib, digest)).digest())
    return (header + b"." + body + b"." + sig).decode()


class JwtProvider(Provider):
    """JWT verification (emqx_authn_jwt.erl): password carries the
    token; verifies signature + exp/nbf, checks optional pinned claims,
    extracts acl/is_superuser claims.

    Three key sources, as in the reference:
    - ``secret``: HMAC (HS256/384/512)
    - ``public_key_pem``: RSA/ECDSA public key (RS256/384/512, ES256)
    - ``jwks`` / ``jwks_fn``: a JWKS document (or a zero-arg fetcher —
      the endpoint transport is injected like HttpProvider's, so tests
      run socketless); keys select by the token header's ``kid`` and a
      verification miss triggers ONE refresh (key rotation)."""

    id = "jwt"

    def __init__(self, secret: bytes = b"", algorithm: str = "HS256",
                 verify_claims: Optional[dict] = None,
                 from_field: str = "password",
                 public_key_pem: Optional[bytes] = None,
                 jwks: Optional[dict] = None,
                 jwks_fn: Optional[Callable[[], dict]] = None) -> None:
        if algorithm.startswith("HS") and not secret:
            # an empty HMAC secret verifies attacker-minted tokens
            # (HMAC(b"") is computable by anyone) — refuse at config
            # time; key sources don't help, HS* only ever uses `secret`
            raise ValueError(
                "jwt: HS* algorithms require a non-empty secret")
        self.secret = secret
        self.algorithm = algorithm
        self.verify_claims = verify_claims or {}
        self.from_field = from_field             # password | username
        self.public_key_pem = public_key_pem
        self._static_key = None
        if public_key_pem is not None:
            # parse ONCE — a malformed PEM fails at config time, not per
            # CONNECT, and the hot path skips re-parsing
            from cryptography.hazmat.primitives.serialization import (
                load_pem_public_key)
            self._static_key = load_pem_public_key(public_key_pem)
        self.jwks_fn = jwks_fn
        self._jwks = jwks or ({} if jwks_fn is None else None)
        self._jwks_keys = (None if self._jwks is None
                           else self._parse_jwks(self._jwks))
        # refresh throttle: a flood of bad-signature tokens must not
        # amplify into one endpoint fetch each (the reference refreshes
        # on an interval, emqx_authn_jwt ssl/refresh_interval)
        self.jwks_min_refresh_s = 5.0
        self._jwks_fetched_at = 0.0

    # -- asymmetric verification -------------------------------------------

    _RS = {"RS256": "sha256", "RS384": "sha384", "RS512": "sha512"}

    @staticmethod
    def _parse_jwks(doc: dict) -> list:
        """JWKS → [(kid, kty, key_object)], parsed ONCE per fetch — key
        construction is off the per-CONNECT hot path."""
        out = []
        for jwk in (doc or {}).get("keys", []):
            try:
                if jwk.get("kty") == "RSA":
                    from cryptography.hazmat.primitives.asymmetric.rsa \
                        import RSAPublicNumbers
                    n = int.from_bytes(_unb64url(jwk["n"]), "big")
                    e = int.from_bytes(_unb64url(jwk["e"]), "big")
                    out.append((jwk.get("kid"), "RSA",
                                RSAPublicNumbers(e, n).public_key()))
                elif jwk.get("kty") == "EC" and jwk.get("crv") == "P-256":
                    from cryptography.hazmat.primitives.asymmetric.ec \
                        import SECP256R1, EllipticCurvePublicNumbers
                    x = int.from_bytes(_unb64url(jwk["x"]), "big")
                    y = int.from_bytes(_unb64url(jwk["y"]), "big")
                    out.append((jwk.get("kid"), "EC",
                                EllipticCurvePublicNumbers(
                                    x, y, SECP256R1()).public_key()))
            except Exception:            # malformed JWK entry: skip it
                continue
        return out

    def _refresh_jwks(self) -> None:
        try:
            doc = self.jwks_fn() or {}
        except Exception:
            # keep (or establish) a doc even on failure: `_jwks is None`
            # marks "never fetched" and would bypass the refresh
            # throttle, turning a dead endpoint into per-token blocking
            # fetches
            self._jwks = self._jwks or {}
            return
        self._jwks = doc
        self._jwks_keys = self._parse_jwks(doc)

    def _jwks_keys_view(self, refresh: bool = False) -> list:
        if self.jwks_fn is not None:
            now = time.time()
            first = self._jwks is None
            if (first or refresh) and (
                    first or now - self._jwks_fetched_at
                    >= self.jwks_min_refresh_s):
                self._jwks_fetched_at = now
                # the first fetch and a verification-miss refresh (key
                # rotation) must complete before verification proceeds;
                # the throttle bounds loop stalls to one fetch per
                # jwks_min_refresh_s even under a bad-token flood
                self._refresh_jwks()
        if self._jwks_keys is None:
            self._jwks_keys = self._parse_jwks(self._jwks)
        return self._jwks_keys

    def _candidate_keys(self, alg: str, header: dict,
                        refresh: bool = False) -> list:
        """All plausibly matching public keys (kid match if present,
        kty compatible with alg) — a no-kid token against a multi-key
        JWKS tries each."""
        if self._static_key is not None:
            return [self._static_key]
        want_kty = "RSA" if alg in self._RS else "EC"
        kid = header.get("kid")
        return [key for k_kid, k_kty, key
                in self._jwks_keys_view(refresh)
                if k_kty == want_kty
                and (kid is None or k_kid == kid)]

    def _verify_asym(self, alg: str, header: dict, signing: bytes,
                     sig: bytes) -> bool:
        from cryptography.hazmat.primitives import hashes as chashes

        digest = {"sha256": chashes.SHA256, "sha384": chashes.SHA384,
                  "sha512": chashes.SHA512}
        for refresh in (False, True):
            for key in self._candidate_keys(alg, header, refresh=refresh):
                try:
                    if alg in self._RS:
                        from cryptography.hazmat.primitives.asymmetric \
                            .padding import PKCS1v15
                        key.verify(sig, signing, PKCS1v15(),
                                   digest[self._RS[alg]]())
                    else:                # ES256: raw r||s → DER
                        from cryptography.hazmat.primitives.asymmetric \
                            .ec import ECDSA
                        from cryptography.hazmat.primitives.asymmetric \
                            .utils import encode_dss_signature
                        half = len(sig) // 2
                        der = encode_dss_signature(
                            int.from_bytes(sig[:half], "big"),
                            int.from_bytes(sig[half:], "big"))
                        key.verify(der, signing, ECDSA(chashes.SHA256()))
                    return True
                except Exception:        # wrong key type/size included —
                    continue             # any failure = not verified
            if self.jwks_fn is None:
                return False             # static keys can't refresh
        return False

    def authenticate(self, cred: Credential):
        token = cred.get(self.from_field)
        if not token:
            return "ignore"
        if isinstance(token, bytes):
            token = token.decode(errors="replace")
        parts = token.split(".")
        if len(parts) != 3:
            return "ignore"                      # not a JWT → next provider
        try:
            header = json.loads(_unb64url(parts[0]))
            claims = json.loads(_unb64url(parts[1]))
            sig = _unb64url(parts[2])
        except Exception:
            return "ignore"
        if not isinstance(header, dict) or not isinstance(claims, dict):
            return ("error", "bad_token")
        alg = header.get("alg")
        if alg != self.algorithm:
            return ("error", "bad_token_algorithm")
        signing = f"{parts[0]}.{parts[1]}".encode()
        if alg in ("HS256", "HS384", "HS512"):
            digest = {"HS256": "sha256", "HS384": "sha384",
                      "HS512": "sha512"}[alg]
            expect = hmac.new(self.secret, signing,
                              getattr(hashlib, digest)).digest()
            if not hmac.compare_digest(expect, sig):
                return ("error", "bad_token_signature")
        elif alg in ("RS256", "RS384", "RS512", "ES256"):
            if not self._verify_asym(alg, header, signing, sig):
                return ("error", "bad_token_signature")
        else:
            return ("error", "bad_token_algorithm")
        now = time.time()
        try:
            exp = float(claims["exp"]) if "exp" in claims else None
            nbf = float(claims["nbf"]) if "nbf" in claims else None
        except (TypeError, ValueError):
            return ("error", "bad_token_claims")
        if exp is not None and now >= exp:
            return ("error", "token_expired")
        if nbf is not None and now < nbf:
            return ("error", "token_not_yet_valid")
        for k, want in self.verify_claims.items():
            # placeholder ${clientid}/${username} as in the reference
            if want == "${clientid}":
                want = cred.get("clientid")
            elif want == "${username}":
                want = cred.get("username")
            if claims.get(k) != want:
                return ("error", "claim_mismatch")
        extras: dict[str, Any] = {
            "is_superuser": bool(claims.get("is_superuser", False))
        }
        if "acl" in claims:
            extras["acl"] = claims["acl"]
        if exp is not None:
            extras["expire_at"] = exp
        return ("ok", extras)


# -- HTTP -----------------------------------------------------------------


class HttpProvider(Provider):
    """External HTTP authenticator (emqx_authn_http.erl): POSTs the
    credential, maps {result: allow|deny|ignore, is_superuser} replies.
    The transport is injected (``request_fn(body_dict) -> dict | None``)
    so unit tests run without sockets; production wires an http client."""

    id = "password_based:http"

    def __init__(self, request_fn: Callable[[dict], Optional[dict]]) -> None:
        self.request_fn = request_fn

    def authenticate(self, cred: Credential):
        body = {
            "clientid": cred.get("clientid"),
            "username": cred.get("username"),
            "password": (
                cred.get("password").decode(errors="replace")
                if isinstance(cred.get("password"), bytes)
                else cred.get("password")
            ),
            "peername": cred.get("peername"),
        }
        try:
            resp = self.request_fn(body)
        except Exception:
            return "ignore"                      # backend down → next provider
        if resp is None:
            return "ignore"
        result = resp.get("result", "ignore")
        if result == "allow":
            return ("ok", {"is_superuser": bool(resp.get("is_superuser"))})
        if result == "deny":
            return ("error", "http_denied")
        return "ignore"


# -- SCRAM-SHA-256 (enhanced auth) ----------------------------------------


class ScramProvider(Provider):
    """SCRAM-SHA-256 for MQTT5 enhanced authentication
    (emqx_enhanced_authn_scram_mnesia.erl). Holds per-user
    StoredKey/ServerKey/salt; speaks the client-first → server-first →
    client-final → server-final exchange via ``step``."""

    id = "scram:built_in_database"
    _ALG = "sha256"

    PENDING_TTL_S = 60.0          # abandoned-exchange expiry

    def __init__(self, iterations: int = 4096) -> None:
        self.iterations = iterations
        self._users: dict[str, dict] = {}
        self._pending: dict[str, dict] = {}      # clientid → exchange state

    def add_user(self, username: str, password: str,
                 is_superuser: bool = False) -> None:
        salt = os.urandom(16)
        salted = hashlib.pbkdf2_hmac(
            self._ALG, password.encode(), salt, self.iterations)
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        self._users[username] = {
            "salt": salt,
            "stored_key": hashlib.sha256(client_key).digest(),
            "server_key": hmac.new(salted, b"Server Key",
                                   hashlib.sha256).digest(),
            "is_superuser": is_superuser,
        }

    def step(self, clientid: str, data: bytes):
        """Drive one exchange step; returns ("continue", out) |
        ("ok", extras) | ("error", reason)."""
        st = self._pending.get(clientid)
        if st is not None and time.time() - st["at"] > self.PENDING_TTL_S:
            del self._pending[clientid]
            st = None                            # stale → restart exchange
        if st is None:
            return self._client_first(clientid, data)
        return self._client_final(clientid, st, data)

    def gc(self, now=None) -> None:
        """Sweep abandoned exchanges (housekeeping tick)."""
        now = time.time() if now is None else now
        dead = [cid for cid, st in self._pending.items()
                if now - st["at"] > self.PENDING_TTL_S]
        for cid in dead:
            del self._pending[cid]

    def _client_first(self, clientid: str, data: bytes):
        try:
            fields = dict(
                kv.split(b"=", 1) for kv in data.split(b",") if b"=" in kv)
            username = fields[b"n"].decode()
            cnonce = fields[b"r"]
        except Exception:
            return ("error", "bad_client_first")
        row = self._users.get(username)
        if row is None:
            return ("error", "not_authorized")
        snonce = cnonce + _b64url(os.urandom(12))
        bare = b"n=" + username.encode() + b",r=" + cnonce
        server_first = (b"r=" + snonce + b",s="
                        + base64.b64encode(row["salt"])
                        + b",i=" + str(self.iterations).encode())
        self._pending[clientid] = {
            "row": row, "nonce": snonce, "at": time.time(),
            "auth_message_prefix": bare + b"," + server_first + b",",
        }
        return ("continue", server_first)

    def _client_final(self, clientid: str, st: dict, data: bytes):
        try:
            fields = dict(
                kv.split(b"=", 1) for kv in data.split(b",") if b"=" in kv)
            nonce, proof = fields[b"r"], base64.b64decode(fields[b"p"])
        except Exception:
            return ("error", "bad_client_final")
        if nonce != st["nonce"]:
            return ("error", "nonce_mismatch")
        row = st["row"]
        without_proof = data.rsplit(b",p=", 1)[0]
        auth_message = st["auth_message_prefix"] + without_proof
        # ClientSignature = HMAC(StoredKey, AuthMessage);
        # ClientKey = Proof XOR Sig; verify H(ClientKey) == StoredKey
        sig = hmac.new(row["stored_key"], auth_message,
                       hashlib.sha256).digest()
        client_key = bytes(a ^ b for a, b in zip(proof, sig))
        del self._pending[clientid]
        if hashlib.sha256(client_key).digest() != row["stored_key"]:
            return ("error", "bad_proof")
        server_sig = hmac.new(row["server_key"], auth_message,
                              hashlib.sha256).digest()
        return ("ok", {"is_superuser": row["is_superuser"],
                       "server_final": b"v=" + base64.b64encode(server_sig)})

    def authenticate(self, cred: Credential):
        return "ignore"                          # only via enhanced auth


# -- the chain ------------------------------------------------------------


class AuthnChain:
    """Ordered provider chain (one per listener in the reference;
    emqx_authentication.erl:228-283)."""

    def __init__(self, providers: Optional[list[Provider]] = None) -> None:
        self.providers: list[Provider] = list(providers or [])

    def add(self, provider: Provider, front: bool = False) -> None:
        if front:
            self.providers.insert(0, provider)
        else:
            self.providers.append(provider)

    def remove(self, provider_id: str) -> None:
        self.providers = [p for p in self.providers if p.id != provider_id]

    def authenticate(self, cred: Credential):
        """→ ("ok", extras) | ("error", reason). Empty chain → anonymous ok."""
        if not self.providers:
            return ("ok", {})
        for p in self.providers:
            ret = p.authenticate(cred)
            if ret == "ignore":
                continue
            return ret
        return ("error", "not_authorized")       # all ignored → deny
