"""TLS context construction for listeners and clients — the ssl-option
surface of ``emqx_listeners.erl:196-238`` (esockd ssl/wss listeners) and
``apps/emqx_psk/`` (TLS-PSK), built on the stdlib ``ssl`` module.

Design notes (vs the reference):

- The reference passes esockd ``ssl_options`` (certfile/keyfile/cacertfile,
  ``verify``/``fail_if_no_peer_cert``, ``versions``, ``ciphers``, depth).
  The same option names are accepted here and mapped onto
  ``ssl.SSLContext`` so listener configs translate one-to-one.
- ``peer_cert_as_username`` / ``peer_cert_as_clientid`` (cn|dn|crt|pem|md5,
  ``emqx_schema.erl`` listener opts) are implemented by the connection
  host: :func:`peer_cert_identity` extracts the fields from the
  handshake's peer certificate and the listener rewrites the CONNECT.
- TLS-PSK (``apps/emqx_psk/src/emqx_psk.erl`` lookup surface): the
  ``PskStore`` table plugs in via ``SSLContext.set_psk_server_callback``,
  which CPython exposes from 3.13. On older runtimes the wiring is
  detected and reported at listener-build time rather than failing the
  handshake mysteriously (``psk_supported()``).
- DTLS (CoAP/MQTT-SN gateways in the reference) has no stdlib transport;
  the gateways keep their UDP listeners and DTLS stays an explicitly
  gated slot (as QUIC/msquic is).
"""

from __future__ import annotations

import ssl
from typing import Optional

_VERSIONS = {
    "tlsv1": ssl.TLSVersion.TLSv1,
    "tlsv1.1": ssl.TLSVersion.TLSv1_1,
    "tlsv1.2": ssl.TLSVersion.TLSv1_2,
    "tlsv1.3": ssl.TLSVersion.TLSv1_3,
}


def psk_supported() -> bool:
    """True when the runtime ssl module can serve TLS-PSK (CPython 3.13+)."""
    return hasattr(ssl.SSLContext, "set_psk_server_callback")


def _apply_versions(ctx: ssl.SSLContext, versions) -> None:
    if not versions:
        # reference default: tlsv1.2 + tlsv1.3 (emqx_schema.erl ssl defaults)
        versions = ["tlsv1.2", "tlsv1.3"]
    unknown = [v for v in versions if v.lower() not in _VERSIONS]
    if unknown:
        raise ValueError(
            f"unknown TLS version(s) {unknown!r} in ssl_options.versions "
            f"(expected one of {sorted(_VERSIONS)})")
    order = list(_VERSIONS)
    idx = sorted({order.index(v.lower()) for v in versions})
    if idx != list(range(idx[0], idx[-1] + 1)):
        # SSLContext can only express a min/max range; a non-contiguous
        # list ("tlsv1" + "tlsv1.3") would silently enable the versions
        # in between — refuse rather than weaken the configured posture
        raise ValueError(
            f"non-contiguous TLS version list {sorted(versions)!r}: the "
            "runtime enforces a continuous min..max range")
    vs = sorted(_VERSIONS[v.lower()] for v in versions)
    ctx.minimum_version = vs[0]
    ctx.maximum_version = vs[-1]


def make_server_context(
    opts: dict,
    psk_store=None,
) -> ssl.SSLContext:
    """Build the listener-side context from an ``ssl_options`` dict:
    certfile, keyfile, password, cacertfile, verify
    ("verify_peer"|"verify_none"), fail_if_no_peer_cert, versions,
    ciphers, depth."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    _apply_versions(ctx, opts.get("versions"))
    certfile = opts.get("certfile")
    if certfile:
        ctx.load_cert_chain(
            certfile, opts.get("keyfile") or None,
            opts.get("password") or None)
    cacertfile = opts.get("cacertfile")
    if cacertfile:
        ctx.load_verify_locations(cacertfile)
    if opts.get("verify", "verify_none") == "verify_peer":
        # esockd: verify_peer + fail_if_no_peer_cert=false still completes
        # the handshake without a client cert (CERT_OPTIONAL)
        ctx.verify_mode = (
            ssl.CERT_REQUIRED if opts.get("fail_if_no_peer_cert")
            else ssl.CERT_OPTIONAL)
    else:
        ctx.verify_mode = ssl.CERT_NONE
    ciphers = opts.get("ciphers")
    if ciphers:
        ctx.set_ciphers(":".join(ciphers)
                        if isinstance(ciphers, (list, tuple)) else ciphers)
    if psk_store is not None:
        if not psk_supported():
            raise RuntimeError(
                "TLS-PSK requires CPython >= 3.13 "
                "(ssl.SSLContext.set_psk_server_callback); "
                "gate the listener's enable_psk on tls.psk_supported()")

        def _psk_cb(identity: Optional[str]):
            key = psk_store.lookup(identity or "")
            return key if key is not None else b""

        ctx.set_psk_server_callback(_psk_cb)
    return ctx


def make_client_context(opts: Optional[dict] = None) -> ssl.SSLContext:
    """Client-side context (MQTT bridge egress, test clients): cacertfile
    to pin the server CA, certfile/keyfile for mutual TLS, verify
    "verify_none" to skip server-cert checks."""
    opts = opts or {}
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    _apply_versions(ctx, opts.get("versions"))
    cacertfile = opts.get("cacertfile")
    if cacertfile:
        ctx.load_verify_locations(cacertfile)
    else:
        ctx.load_default_certs()
    if opts.get("verify", "verify_peer") == "verify_none":
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    certfile = opts.get("certfile")
    if certfile:
        ctx.load_cert_chain(
            certfile, opts.get("keyfile") or None,
            opts.get("password") or None)
    return ctx


def peer_cert_identity(peercert: Optional[dict]) -> dict:
    """Extract the identity fields a listener's ``peer_cert_as_username``
    / ``peer_cert_as_clientid`` option selects from (cn | dn); ``crt``/
    ``pem``/``md5`` need the DER bytes, which the connection host passes
    separately when configured."""
    if not peercert:
        return {}
    out: dict = {"peercert": peercert}
    rdns = peercert.get("subject", ())
    parts = []
    for rdn in rdns:
        for name, value in rdn:
            if name == "commonName":
                out.setdefault("cn", value)
            parts.append(f"{_DN_ABBREV.get(name, name)}={value}")
    if parts:
        out["dn"] = ",".join(reversed(parts))
    return out


_DN_ABBREV = {
    "commonName": "CN", "countryName": "C", "stateOrProvinceName": "ST",
    "localityName": "L", "organizationName": "O",
    "organizationalUnitName": "OU", "emailAddress": "emailAddress",
}
