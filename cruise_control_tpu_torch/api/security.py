"""HTTP security: pluggable provider, basic/JWT/trusted-proxy auth, roles (counterpart of
``cruise_control_tpu/api/security.py``).

Reference: servlet/security/ — SecurityProvider SPI, BasicSecurityProvider
(htpasswd-style credential file), jwt/ (JwtAuthenticator + JwtLoginService),
trusted-proxy (TrustedProxyAuthenticator: an authenticated proxy forwards the
end user via ``doAs``), DefaultRoleSecurityProvider with roles
VIEWER/USER/ADMIN. SPNEGO is Kerberos/Jetty-specific and is represented by
the same SPI seam (a provider maps request credentials ->
(principal, role)); the default deployment is unauthenticated, matching the
reference's webserver.security.enable=false default (WebServerConfig.java).

Role semantics (DefaultRoleSecurityProvider):
  VIEWER — monitor-type endpoints (STATE, LOAD, PROPOSALS, ...)
  USER   — viewer + CRUISE_CONTROL_MONITOR admin-reads (REVIEW_BOARD, USER_TASKS)
  ADMIN  — everything, including KAFKA_ADMIN / CRUISE_CONTROL_ADMIN POSTs.
"""
from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json
import time

from cruise_control_tpu_torch.api.endpoints import EndPoint, EndpointType

ROLE_VIEWER = "VIEWER"
ROLE_USER = "USER"
ROLE_ADMIN = "ADMIN"
_ROLE_RANK = {ROLE_VIEWER: 0, ROLE_USER: 1, ROLE_ADMIN: 2}


def required_role(endpoint: EndPoint, method: str) -> str:
    if method == "POST" or endpoint.endpoint_type in (
            EndpointType.KAFKA_ADMIN, EndpointType.CRUISE_CONTROL_ADMIN):
        return ROLE_ADMIN
    if endpoint in (EndPoint.USER_TASKS, EndPoint.REVIEW_BOARD):
        return ROLE_USER
    return ROLE_VIEWER


class AuthError(Exception):
    def __init__(self, message: str, status: int = 401,
                 extra_headers: dict | None = None):
        super().__init__(message)
        self.status = status
        self.extra_headers = extra_headers or {}


class SecurityProvider:
    """SPI: authenticate a request, returning (principal, role).
    ``client_ip`` is the peer address (trusted-proxy IP allowlisting)."""

    def authenticate(self, headers, client_ip: str | None = None) -> tuple[str, str]:
        raise NotImplementedError

    def authorize(self, role: str, endpoint: EndPoint, method: str) -> bool:
        need = required_role(endpoint, method)
        return _ROLE_RANK.get(role, -1) >= _ROLE_RANK[need]


class NoopSecurityProvider(SecurityProvider):
    """Security disabled: everyone is ADMIN (webserver.security.enable=false)."""

    def authenticate(self, headers, client_ip: str | None = None) -> tuple[str, str]:
        return ("anonymous", ROLE_ADMIN)


class BasicSecurityProvider(SecurityProvider):
    """HTTP Basic auth against a credentials map.

    Credentials come from config ``webserver.auth.credentials.file`` with
    htpasswd-ish lines ``user: password, ROLE`` (the reference's Jetty
    HashLoginService realm file format).
    """

    def __init__(self, credentials: dict[str, tuple[str, str]]):
        self._creds = credentials  # user -> (password, role)

    def user_roles(self) -> dict[str, str]:
        """user -> role map (trusted-proxy reuses the realm file for doAs
        principals' roles)."""
        return {u: role for u, (_pw, role) in self._creds.items()}

    @classmethod
    def from_file(cls, path: str) -> "BasicSecurityProvider":
        creds = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                user, rest = line.split(":", 1)
                password, role = (x.strip() for x in rest.rsplit(",", 1))
                creds[user.strip()] = (password, role.upper())
        return cls(creds)

    def authenticate(self, headers, client_ip: str | None = None) -> tuple[str, str]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Basic "):
            raise AuthError("authentication required", 401)
        try:
            user, _, password = base64.b64decode(
                auth[6:].strip()).decode("utf-8").partition(":")
        except (binascii.Error, UnicodeDecodeError):
            raise AuthError("malformed Basic credentials", 401) from None
        entry = self._creds.get(user)
        if entry is None or entry[0] != password:
            raise AuthError("bad credentials", 401)
        return (user, entry[1])


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


# --------------------------------------------------------------------------
# Minimal DER walk: enough ASN.1 to pull (n, e) out of a PEM public key or
# certificate, so RS256 JWT verification (jwt.auth.certificate.location —
# the reference's JwtLoginService verifies RS256 against the IdP cert) works
# without a cryptography dependency.
# --------------------------------------------------------------------------
def _der_read(buf: bytes, pos: int):
    """One TLV: returns (tag, content, next_pos)."""
    tag = buf[pos]
    length = buf[pos + 1]
    pos += 2
    if length & 0x80:
        n = length & 0x7F
        length = int.from_bytes(buf[pos:pos + n], "big")
        pos += n
    return tag, buf[pos:pos + length], pos + length


def _find_rsa_key(der: bytes):
    """Depth-first search for SEQUENCE(INTEGER modulus, INTEGER exponent)
    anywhere in the DER (covers PKCS#1, SPKI, and full certificates)."""
    stack = [der]
    while stack:
        buf = stack.pop()
        pos = 0
        while pos < len(buf):
            try:
                tag, content, pos = _der_read(buf, pos)
            except (IndexError, ValueError):
                break
            if tag == 0x30:  # SEQUENCE
                try:
                    t1, c1, p1 = _der_read(content, 0)
                    t2, c2, _ = _der_read(content, p1)
                    if t1 == 0x02 and t2 == 0x02 and len(c1) > 32:
                        n = int.from_bytes(c1, "big")
                        e = int.from_bytes(c2, "big")
                        if n > 0 and 3 <= e < 1 << 33:
                            return n, e
                except (IndexError, ValueError):
                    pass
                stack.append(content)
            elif tag == 0x03 and content[:1] == b"\x00":  # BIT STRING
                stack.append(content[1:])
    return None


def rsa_public_key_from_pem(pem: str):
    """(n, e) from a PEM public key / RSA public key / X.509 certificate."""
    import re as _re
    blocks = _re.findall(r"-----BEGIN [^-]+-----(.*?)-----END [^-]+-----",
                         pem, _re.S)
    for block in blocks:
        der = base64.b64decode("".join(block.split()))
        key = _find_rsa_key(der)
        if key is not None:
            return key
    raise ValueError("no RSA public key found in PEM")


# SHA-256 DigestInfo prefix (EMSA-PKCS1-v1_5)
_SHA256_DIGEST_INFO = bytes.fromhex(
    "3031300d060960864801650304020105000420")


def _rs256_verify(n: int, e: int, signing_input: bytes, sig: bytes) -> bool:
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n).to_bytes(k, "big")
    digest = hashlib.sha256(signing_input).digest()
    em = (b"\x00\x01" + b"\xff" * (k - 3 - len(_SHA256_DIGEST_INFO) - 32)
          + b"\x00" + _SHA256_DIGEST_INFO + digest)
    return hmac.compare_digest(m, em)


class JwtSecurityProvider(SecurityProvider):
    """Bearer-token auth: HS256 JWTs verified against a shared secret.

    Reference: servlet/security/jwt/JwtAuthenticator + JwtLoginService —
    there an RS256 cert from ``jwt.authentication.provider.url``; here an
    HMAC shared secret (no cryptography dependency), same claims contract:
    the principal comes from the configured user-claim, expiry is enforced,
    and the role is looked up in the authorized-users map (or taken from a
    ``role`` claim when no map is given).
    """

    def __init__(self, secret: bytes | str | None = None,
                 roles: dict[str, str] | None = None,
                 principal_claim: str = "sub", clock=time.time,
                 cookie_name: str = "", expected_audiences: list | None = None,
                 provider_url: str = "", rs256_key: tuple | None = None):
        """``cookie_name`` (jwt.cookie.name): also accept the token from this
        cookie; ``expected_audiences`` (jwt.expected.audiences): accepted
        'aud' claim values; ``provider_url`` (jwt.authentication.provider.
        url): login service a token-less browser is redirected to;
        ``rs256_key`` (n, e) from jwt.auth.certificate.location enables
        RS256-signed tokens (the reference's IdP-certificate path)."""
        if secret is None and rs256_key is None:
            raise ValueError("JWT security needs jwt.secret.file (HS256) "
                             "and/or jwt.auth.certificate.location (RS256)")
        self._rs256_key = rs256_key
        secret = b"" if secret is None else secret
        self._secret = secret.encode() if isinstance(secret, str) else secret
        self._roles = {u: r.upper() for u, r in (roles or {}).items()}
        self._claim = principal_claim
        self._clock = clock
        self._cookie_name = cookie_name
        self._audiences = (set(expected_audiences)
                           if expected_audiences else None)
        self._provider_url = provider_url

    def _missing_token_error(self) -> AuthError:
        if self._provider_url:
            # the reference's JwtAuthenticator bounces browsers to the login
            # service with the original URL for post-login return
            return AuthError("authentication required", 302,
                             extra_headers={"Location": self._provider_url})
        return AuthError("bearer token required", 401)

    def authenticate(self, headers, client_ip: str | None = None) -> tuple[str, str]:
        auth = headers.get("Authorization", "")
        token = ""
        if auth.startswith("Bearer "):
            token = auth[7:].strip()
        elif self._cookie_name:
            import http.cookies
            cookies = http.cookies.SimpleCookie(headers.get("Cookie", ""))
            if self._cookie_name in cookies:
                token = cookies[self._cookie_name].value
        if not token:
            raise self._missing_token_error()
        parts = token.split(".")
        if len(parts) != 3:
            raise AuthError("malformed JWT", 401)
        try:
            header = json.loads(_b64url_decode(parts[0]))
            payload = json.loads(_b64url_decode(parts[1]))
            sig = _b64url_decode(parts[2])
        except (binascii.Error, ValueError):
            raise AuthError("malformed JWT", 401) from None
        signing_input = f"{parts[0]}.{parts[1]}".encode("ascii")
        alg = header.get("alg")
        if alg == "HS256" and self._secret:
            expect = hmac.new(self._secret, signing_input,
                              hashlib.sha256).digest()
            if not hmac.compare_digest(sig, expect):
                raise AuthError("bad JWT signature", 401)
        elif alg == "RS256" and self._rs256_key is not None:
            n, e = self._rs256_key
            if not _rs256_verify(n, e, signing_input, sig):
                raise AuthError("bad JWT signature", 401)
        else:
            raise AuthError(f"unsupported JWT alg {alg!r}", 401)
        exp = payload.get("exp")
        if exp is not None and self._clock() >= float(exp):
            raise AuthError("JWT expired", 401)
        if self._audiences is not None:
            # jwt.expected.audiences: at least one 'aud' value must match
            aud = payload.get("aud")
            auds = set(aud) if isinstance(aud, list) else {aud} if aud else set()
            if not (auds & self._audiences):
                raise AuthError(
                    f"JWT audience {sorted(auds)} not among expected "
                    f"{sorted(self._audiences)}", 401)
        principal = payload.get(self._claim)
        if not principal:
            raise AuthError(f"JWT missing {self._claim!r} claim", 401)
        if self._roles:
            role = self._roles.get(principal)
            if role is None:
                raise AuthError(f"user {principal!r} not authorized", 403)
        else:
            role = str(payload.get("role", ROLE_VIEWER)).upper()
        if role not in _ROLE_RANK:
            raise AuthError(f"unknown role {role!r}", 403)
        return (principal, role)

    @staticmethod
    def make_token(secret: bytes | str, principal: str, role: str | None = None,
                   expires_in_s: float | None = 3600.0,
                   principal_claim: str = "sub", clock=time.time) -> str:
        """Mint an HS256 token (test/ops utility — the reference's login
        service is external; this is its stand-in for round-trip tests)."""
        secret = secret.encode() if isinstance(secret, str) else secret
        def enc(obj):
            return base64.urlsafe_b64encode(
                json.dumps(obj, separators=(",", ":")).encode()).rstrip(b"=").decode()
        payload = {principal_claim: principal}
        if role is not None:
            payload["role"] = role
        if expires_in_s is not None:
            payload["exp"] = clock() + expires_in_s
        head_body = f"{enc({'alg': 'HS256', 'typ': 'JWT'})}.{enc(payload)}"
        sig = hmac.new(secret, head_body.encode("ascii"), hashlib.sha256).digest()
        return f"{head_body}.{base64.urlsafe_b64encode(sig).rstrip(b'=').decode()}"


class TrustedProxySecurityProvider(SecurityProvider):
    """An authenticated proxy service forwards the real user.

    Reference: servlet/security/trustedproxy/ — the proxy authenticates
    itself (here: via a delegate provider, e.g. Basic or JWT) and names the
    end user in the ``doAs`` request header/parameter; only principals in the
    trusted-service list may delegate, optionally restricted to an IP
    allowlist (trusted.proxy.services / trusted.proxy.spnego.fallback roles).
    """

    DO_AS_HEADER = "X-Do-As"

    def __init__(self, delegate: SecurityProvider, trusted_services: list[str],
                 user_roles: dict[str, str] | None = None,
                 fallback_to_delegate: bool = True,
                 ip_regex: str = ""):
        """``ip_regex`` (trusted.proxy.services.ip.regex): only peers whose
        IP matches may act as trusted proxies ('' = any)."""
        import re
        self._delegate = delegate
        self._trusted = set(trusted_services)
        self._user_roles = {u: r.upper() for u, r in (user_roles or {}).items()}
        self._fallback = fallback_to_delegate
        self._ip_rx = re.compile(ip_regex) if ip_regex else None

    def authenticate(self, headers, client_ip: str | None = None) -> tuple[str, str]:
        principal, role = self._delegate.authenticate(headers,
                                                      client_ip=client_ip)
        do_as = headers.get(self.DO_AS_HEADER)
        if not do_as:
            if self._fallback:
                return (principal, role)
            raise AuthError("trusted proxy requests must carry "
                            f"{self.DO_AS_HEADER}", 401)
        if principal not in self._trusted:
            raise AuthError(f"{principal!r} is not a trusted proxy", 403)
        if self._ip_rx is not None and not (
                client_ip and self._ip_rx.fullmatch(client_ip)):
            raise AuthError(
                f"client ip {client_ip!r} not allowed to proxy "
                f"(trusted.proxy.services.ip.regex)", 403)
        if self._user_roles:
            # a roles map is authoritative: unknown doAs principals are
            # rejected, matching direct-auth behavior for unknown users
            user_role = self._user_roles.get(do_as)
            if user_role is None:
                raise AuthError(f"doAs principal {do_as!r} not authorized", 403)
        else:
            user_role = ROLE_VIEWER
        return (do_as, user_role)


class SpnegoSecurityProvider(SecurityProvider):
    """SPNEGO/Negotiate-shaped provider (servlet/security/spnego/ role:
    SpnegoSecurityProvider + Jetty's ConfigurableSpnegoAuthenticator).

    Implements the HTTP Negotiate handshake contract:
    - no ``Authorization: Negotiate <token>`` -> 401 with a
      ``WWW-Authenticate: Negotiate`` challenge,
    - a presented token is validated by a pluggable ``token_validator``
      (the GSS-API seam; Kerberos itself is not available in this
      environment, so deployments plug their GSS binding here, and tests
      use :func:`hmac_token_validator`),
    - the authenticated principal's service/realm suffixes are stripped
      (``user/host@REALM`` -> ``user``) before role lookup, mirroring
      SpnegoUserStoreAuthorizationService's principal-name normalization.
    """

    def __init__(self, token_validator, roles: dict[str, str] | None = None,
                 default_role: str | None = None,
                 service_principal: str = ""):
        """``service_principal`` (WebServerConfig spnego.principal): the
        server's own principal — tokens minted for another service are
        rejected (the GSS acceptor-name check)."""
        self._validate = token_validator
        self._roles = roles or {}
        self._default_role = default_role
        self._service_principal = service_principal

    @property
    def challenge(self) -> str:
        return "Negotiate"

    def authenticate(self, headers, client_ip: str | None = None) -> tuple[str, str]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Negotiate "):
            raise AuthError("Negotiate authentication required", 401)
        token = auth[len("Negotiate "):].strip()
        principal = self._validate(token)
        if principal is None:
            raise AuthError("invalid Negotiate token", 403)
        if self._service_principal:
            # tokens bound to a service carry "principal\x00service"; when a
            # service principal is pinned, a token WITHOUT any binding is
            # rejected too — otherwise the pinning would be opt-in for the
            # token minter rather than enforced by the server
            if "\x00" not in principal:
                raise AuthError(
                    "token carries no service binding but this server pins "
                    f"{self._service_principal!r} (spnego.principal)", 403)
            principal, _, svc = principal.partition("\x00")
            if svc != self._service_principal:
                raise AuthError(
                    f"token addressed to {svc!r}, this server is "
                    f"{self._service_principal!r} (spnego.principal)", 403)
        # user/service-instance@REALM -> user
        short = principal.split("@")[0].split("/")[0]
        role = self._roles.get(short, self._default_role)
        if role is None:
            raise AuthError(f"principal {short!r} has no role", 403)
        return short, role


def hmac_token_validator(secret: bytes | str):
    """Test/deployment-stub GSS seam for :class:`SpnegoSecurityProvider`:
    accepts base64("principal:" + hex(hmac_sha256(secret, principal)))."""
    key = secret.encode() if isinstance(secret, str) else secret

    def validate(token: str):
        try:
            raw = base64.b64decode(token.encode(), validate=True).decode()
            principal, _, mac = raw.rpartition(":")
        except (binascii.Error, UnicodeDecodeError, ValueError):
            return None
        if not principal:
            return None
        want = hmac.new(key, principal.encode(), hashlib.sha256).hexdigest()
        return principal if hmac.compare_digest(mac, want) else None

    return validate


def make_spnego_token(secret: bytes | str, principal: str,
                      service: str = "") -> str:
    """Mint a token the hmac_token_validator accepts (client/test side).
    ``service`` binds the token to a server principal (spnego.principal):
    the validated identity is then "principal\\x00service"."""
    key = secret.encode() if isinstance(secret, str) else secret
    ident = f"{principal}\x00{service}" if service else principal
    mac = hmac.new(key, ident.encode(), hashlib.sha256).hexdigest()
    return base64.b64encode(f"{ident}:{mac}".encode()).decode()
