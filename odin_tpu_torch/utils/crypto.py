"""Password-based AES encryption for files, folders, and zip archives.

Reference: ``odin/utils/crypto.py`` (encrypt_aes :223, decrypt_aes :304,
zip_aes :379, unzip_aes :419, md5_folder :75).  The reference used the
legacy pycrypto CBC construction; this implementation uses authenticated
AES-256-GCM with a PBKDF2-derived key (own container format, versioned
header), so tampering is detected instead of silently producing garbage.

Container layout: ``b"OTPU1" | salt[16] | nonce[12] | ciphertext+tag``.

The port's copy of the JAX package's ``odin_tpu/utils/crypto.py``, which
imports no JAX.
"""
from __future__ import annotations

import io
import os
import zipfile
from typing import Dict, Optional, Union

from odin_tpu_torch.utils import md5_checksum

__all__ = ["encrypt_aes", "decrypt_aes", "zip_aes", "unzip_aes",
           "md5_folder", "to_password"]

_MAGIC = b"OTPU1"
_PBKDF2_ITERS = 200_000


def _require_cryptography():
  try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM  # noqa
    return True
  except ImportError as e:  # pragma: no cover - baked into the image
    raise ImportError("AES utilities require the `cryptography` package") \
        from e


def to_password(password: Union[str, bytes],
                salt: Optional[bytes] = None) -> bytes:
  """Derive a 32-byte AES key from a password (reference :32, which used a
  bare sha256; PBKDF2-HMAC-SHA256 here for brute-force resistance)."""
  _require_cryptography()
  from cryptography.hazmat.primitives import hashes
  from cryptography.hazmat.primitives.kdf.pbkdf2 import PBKDF2HMAC
  if isinstance(password, str):
    password = password.encode()
  kdf = PBKDF2HMAC(algorithm=hashes.SHA256(), length=32,
                   salt=salt or b"\0" * 16, iterations=_PBKDF2_ITERS)
  return kdf.derive(password)


def _read_data(file_or_data) -> bytes:
  if isinstance(file_or_data, bytes):
    return file_or_data
  if isinstance(file_or_data, str):
    with open(file_or_data, "rb") as f:
      return f.read()
  return file_or_data.read()  # file-like


def encrypt_aes(file_or_data, password: Union[str, bytes],
                outfile: Optional[str] = None) -> Optional[bytes]:
  """Encrypt bytes / a file path / a file object (reference :223).
  Returns ciphertext bytes, or writes to `outfile` and returns None."""
  _require_cryptography()
  from cryptography.hazmat.primitives.ciphers.aead import AESGCM
  data = _read_data(file_or_data)
  salt, nonce = os.urandom(16), os.urandom(12)
  key = to_password(password, salt)
  blob = _MAGIC + salt + nonce + AESGCM(key).encrypt(nonce, data, _MAGIC)
  if outfile is None:
    return blob
  with open(outfile, "wb") as f:
    f.write(blob)
  return None


def decrypt_aes(file_or_data, password: Union[str, bytes],
                outfile: Optional[str] = None) -> Optional[bytes]:
  """Inverse of :func:`encrypt_aes` (reference :304).  Raises ``ValueError``
  on a wrong password or a tampered container (GCM authentication)."""
  _require_cryptography()
  from cryptography.exceptions import InvalidTag
  from cryptography.hazmat.primitives.ciphers.aead import AESGCM
  blob = _read_data(file_or_data)
  if blob[:5] != _MAGIC:
    raise ValueError("not an odin-tpu AES container (bad magic header)")
  salt, nonce, ct = blob[5:21], blob[21:33], blob[33:]
  key = to_password(password, salt)
  try:
    data = AESGCM(key).decrypt(nonce, ct, _MAGIC)
  except InvalidTag:
    raise ValueError("decryption failed: wrong password or corrupted data")
  if outfile is None:
    return data
  with open(outfile, "wb") as f:
    f.write(data)
  return None


def zip_aes(in_path: str, out_path: str,
            password: Optional[Union[str, bytes]] = None,
            compression: bool = True, verbose: bool = False) -> None:
  """Zip a file or directory tree and optionally encrypt the archive
  (reference :379)."""
  buf = io.BytesIO()
  mode = zipfile.ZIP_DEFLATED if compression else zipfile.ZIP_STORED
  with zipfile.ZipFile(buf, "w", mode) as zf:
    if os.path.isdir(in_path):
      root = os.path.abspath(in_path)
      for dirpath, _, files in os.walk(root):
        for name in sorted(files):
          full = os.path.join(dirpath, name)
          arc = os.path.join(os.path.basename(root),
                             os.path.relpath(full, root))
          if verbose:
            print(f"zip: {arc}")
          zf.write(full, arc)
    else:
      zf.write(in_path, os.path.basename(in_path))
  data = buf.getvalue()
  if password is None:
    with open(out_path, "wb") as f:
      f.write(data)
  else:
    encrypt_aes(data, password, outfile=out_path)


def unzip_aes(in_path: str, out_path: str,
              password: Optional[Union[str, bytes]] = None,
              verbose: bool = False) -> None:
  """Decrypt (if a password is given) and extract an archive created by
  :func:`zip_aes` (reference :419)."""
  with open(in_path, "rb") as f:
    blob = f.read()
  if blob[:5] == _MAGIC:
    if password is None:
      raise ValueError(f"{in_path} is encrypted; a password is required")
    blob = decrypt_aes(blob, password)
  with zipfile.ZipFile(io.BytesIO(blob)) as zf:
    if verbose:
      print(f"unzip: {len(zf.namelist())} entries -> {out_path}")
    zf.extractall(out_path)


def md5_folder(path: str, chunksize: int = 1 << 20,
               return_dict: bool = False) -> Union[str, Dict[str, str]]:
  """md5 of an entire directory tree (reference :75): per-file digests in
  sorted relative-path order, combined into one hex digest."""
  import hashlib
  del chunksize  # md5_checksum streams files itself
  digests: Dict[str, str] = {}
  root = os.path.abspath(path)
  for dirpath, _, files in os.walk(root):
    for name in sorted(files):
      full = os.path.join(dirpath, name)
      digests[os.path.relpath(full, root)] = md5_checksum(full)
  if return_dict:
    return digests
  combined = hashlib.md5()
  for rel in sorted(digests):
    combined.update(rel.encode() + digests[rel].encode())
  return combined.hexdigest()
