"""TLS for the port's server (counterpart of
``triton_client_tpu/server/tls.py``).

:class:`TLSConfig` holds the PEM paths and builds the server's
``ssl.SSLContext``s: the HTTP port's (ALPN ``http/1.1`` only, so a client
that tries HTTP/2 first stays on HTTP/1.1 and gRPC-Web) and the gRPC
port's (ALPN ``h2`` only, the same pair: the counterpart of the
reference's ``grpc_credentials``, whose peers refuse a TLS server that
does not negotiate ``h2``).  :func:`maybe_tls` reads the
CLI's ``--ssl-certfile`` / ``--ssl-keyfile`` with the reference's errors.
:func:`generate_self_signed` writes a throwaway certificate and key for
``localhost`` and ``127.0.0.1``: through ``cryptography`` where it is
installed, else through the ``openssl`` command.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import shutil
import ssl
import subprocess
from dataclasses import dataclass
from typing import Optional

__all__ = ["TLSConfig", "generate_self_signed", "maybe_tls"]

#: the seconds a connection's thread waits for its TLS handshake
HANDSHAKE_TIMEOUT_S = 10.0


@dataclass
class TLSConfig:
    """Server-side TLS material (PEM file paths)."""

    certfile: str
    keyfile: str

    def ssl_context(self) -> ssl.SSLContext:
        """The HTTP port's context; raises where the pair does not load."""
        return self._context("http/1.1")

    def grpc_ssl_context(self) -> ssl.SSLContext:
        """The gRPC port's context: the same pair, ALPN ``h2``."""
        return self._context("h2")

    def _context(self, alpn: str) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        ctx.set_alpn_protocols([alpn])
        return ctx


def generate_self_signed(
    directory: str, common_name: str = "localhost", days: int = 7
) -> TLSConfig:
    """Write a throwaway self-signed certificate and key as
    ``directory/server.{crt,key}``.  Its names are ``common_name``,
    ``localhost`` and ``127.0.0.1``, so it verifies for a host name and
    for the loopback address."""
    certfile = os.path.join(directory, "server.crt")
    keyfile = os.path.join(directory, "server.key")
    try:
        import cryptography  # noqa: F401
    except ImportError:
        openssl = shutil.which("openssl")
        if openssl is None:
            raise RuntimeError(
                "generate_self_signed needs the 'cryptography' package or "
                "the 'openssl' command; neither is available")
        _openssl_self_signed(openssl, certfile, keyfile, common_name, days)
    else:
        _cryptography_self_signed(certfile, keyfile, common_name, days)
    return TLSConfig(certfile=certfile, keyfile=keyfile)


def _san_dns(common_name: str) -> list:
    return ([common_name] if common_name != "localhost" else []) + \
        ["localhost"]


def _cryptography_self_signed(certfile: str, keyfile: str,
                              common_name: str, days: int) -> None:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    sans = [x509.DNSName(n) for n in _san_dns(common_name)]
    sans.append(x509.IPAddress(ipaddress.ip_address("127.0.0.1")))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(key, hashes.SHA256())
    )
    with open(certfile, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(keyfile, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))


def _openssl_self_signed(openssl: str, certfile: str, keyfile: str,
                         common_name: str, days: int) -> None:
    san = ",".join([f"DNS:{n}" for n in _san_dns(common_name)]
                   + ["IP:127.0.0.1"])
    out = subprocess.run(
        [openssl, "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", keyfile, "-out", certfile, "-days", str(days),
         "-subj", f"/CN={common_name}", "-addext",
         f"subjectAltName={san}"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"openssl failed: {out.stderr.strip()}")


def maybe_tls(certfile: Optional[str],
              keyfile: Optional[str]) -> Optional[TLSConfig]:
    """The CLI's TLS material: None without either flag."""
    if certfile is None and keyfile is None:
        return None
    if not (certfile and keyfile):
        raise ValueError(
            "--ssl-certfile and --ssl-keyfile must be given together")
    for path in (certfile, keyfile):
        if not os.path.isfile(path):
            raise ValueError(f"TLS file not found: {path}")
    return TLSConfig(certfile=certfile, keyfile=keyfile)
