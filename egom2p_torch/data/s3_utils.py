"""S3 object access for token shards and checkpoints.

Copy of egom2p_tpu/data/s3_utils.py (reference: egom2p/data/s3_utils.py:
29-113), kept here so that the port never loads the JAX package: s3:// path
parsing, a boto3 client made on first use, a streaming read of one object
and a whole-object read.  Every function takes an injected `client` (any
object with boto3's get_object / upload_file / download_file /
list_objects_v2), which is how the tests run without boto3 or a network;
without one, `make_client` imports boto3 and raises, naming it, where it is
not installed.
"""
from __future__ import annotations

import io
import os
from typing import Dict, Optional, Tuple

_CLIENTS: Dict[Tuple[int, Optional[str]], object] = {}


def is_s3_path(path: str) -> bool:
    return str(path).startswith("s3://")


def parse_s3_path(path: str) -> Tuple[str, str]:
    """s3://bucket/key -> (bucket, key)."""
    rest = str(path)[len("s3://"):]
    bucket, _, key = rest.partition("/")
    if not bucket or not key:
        raise ValueError(f"malformed s3 path {path!r}")
    return bucket, key


def make_client(profile: Optional[str] = None, endpoint_url: Optional[str] = None):
    """A boto3 S3 client (reference: s3_utils.py:29-56); the endpoint is
    `endpoint_url`, else $S3_ENDPOINT_URL, else boto3's default."""
    try:
        import boto3
        session_cls = boto3.Session
    except (ImportError, AttributeError) as e:
        raise RuntimeError("s3:// paths need the boto3 package, which is not installed here: "
                           "install boto3, or copy the objects to a local path") from e
    session = session_cls(profile_name=profile) if profile else session_cls()
    return session.client("s3", endpoint_url=endpoint_url or os.environ.get("S3_ENDPOINT_URL"))


def client_for(endpoint_url: Optional[str] = None):
    """This process's client for `endpoint_url`, made on first use (a
    forked loader worker makes its own: clients are not shared across a
    fork)."""
    key = (os.getpid(), endpoint_url)
    if key not in _CLIENTS:
        _CLIENTS[key] = make_client(endpoint_url=endpoint_url)
    return _CLIENTS[key]


def open_stream(path: str, client=None, endpoint_url: Optional[str] = None):
    """A binary stream of a local file or an s3:// object.  An S3 object
    comes as the client's streaming body (not seekable): read it with
    tarfile's streaming mode ("r|*")."""
    if not is_s3_path(path):
        return open(path, "rb")
    client = client or client_for(endpoint_url)
    bucket, key = parse_s3_path(path)
    return client.get_object(Bucket=bucket, Key=key)["Body"]


def download_to_memory(path: str, client=None, endpoint_url: Optional[str] = None) -> io.BytesIO:
    """A whole object (or file) in memory (reference: s3_utils.py:96-113)."""
    body = open_stream(path, client, endpoint_url)
    try:
        return io.BytesIO(body.read())
    finally:
        if hasattr(body, "close"):
            body.close()
