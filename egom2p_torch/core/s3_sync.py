"""S3 checkpoint sync: each saved checkpoint uploaded, the latest one
downloaded for a resume on a machine that has none.

Copy of egom2p_tpu/core/s3_sync.py (reference: egom2p/utils/s3_utils.py:
29-64 save_on_s3 / download_from_s3, egom2p/utils/checkpoint.py:113-120),
for the port's checkpoints, which are single `checkpoint-{tag}.pth` files
(core/checkpoint.py) where the JAX package's are directories: the object
key is <prefix>/checkpoint-{tag}.pth.  The client comes from
data/s3_utils.py:make_client (which raises, naming boto3, where it is not
installed); every function takes an injected `client`.
"""
from __future__ import annotations

import os
import re
import threading
from typing import List, Optional

from egom2p_torch.data.s3_utils import make_client, parse_s3_path

_UPLOAD_THREADS: List[threading.Thread] = []
_UPLOAD_ERRORS: List[BaseException] = []
_CHECKPOINT = re.compile(r"checkpoint-([^/]+)\.pth")


def _client(client, endpoint_url):
    return client or make_client(endpoint_url=endpoint_url)


def upload_checkpoint(local_path: str, s3_dir: str, client=None,
                      endpoint_url: Optional[str] = None) -> str:
    """Upload one checkpoint file to s3_dir/<its name>; returns the s3
    path.  The caller is the rank that wrote the file."""
    client = _client(client, endpoint_url)
    bucket, prefix = parse_s3_path(s3_dir.rstrip("/") + "/" + os.path.basename(local_path))
    client.upload_file(local_path, bucket, prefix)
    return f"s3://{bucket}/{prefix}"


def download_checkpoint(s3_path: str, local_path: str, client=None,
                        endpoint_url: Optional[str] = None) -> str:
    """Download one checkpoint object to `local_path` (its directory made);
    returns `local_path`."""
    client = _client(client, endpoint_url)
    bucket, key = parse_s3_path(s3_path)
    if not _list_keys(client, bucket, key):
        raise FileNotFoundError(f"no object {s3_path}")
    os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
    tmp = f"{local_path}.{os.getpid()}.tmp"
    client.download_file(bucket, key, tmp)
    os.replace(tmp, local_path)
    return local_path


def latest_s3_checkpoint(s3_dir: str, client=None,
                         endpoint_url: Optional[str] = None) -> Optional[str]:
    """The s3 path of the checkpoint-{N}.pth with the largest N directly
    under s3_dir, else checkpoint-final.pth, else None (as
    core/checkpoint.py:latest_checkpoint chooses)."""
    client = _client(client, endpoint_url)
    bucket, prefix = parse_s3_path(s3_dir.rstrip("/"))
    tags = set()
    for key in _list_keys(client, bucket, prefix + "/"):
        m = _CHECKPOINT.fullmatch(key[len(prefix) + 1:])
        if m:
            tags.add(m.group(1))
    numbered = [int(t) for t in tags if t.isdigit()]
    best = str(max(numbered)) if numbered else ("final" if "final" in tags else None)
    return f"s3://{bucket}/{prefix}/checkpoint-{best}.pth" if best else None


def maybe_download_for_resume(output_dir: str, s3_dir: str, client=None,
                              endpoint_url: Optional[str] = None) -> Optional[str]:
    """Where output_dir holds no checkpoint and s3_dir does, download the
    latest into output_dir and return its local path; else None (a local
    checkpoint wins).  Called before core/checkpoint.py:auto_load_model."""
    from egom2p_torch.core.checkpoint import latest_checkpoint
    if latest_checkpoint(output_dir) is not None:
        return None
    remote = latest_s3_checkpoint(s3_dir, client, endpoint_url)
    if remote is None:
        return None
    return download_checkpoint(remote, os.path.join(output_dir, remote.rsplit("/", 1)[1]),
                               client, endpoint_url)


def upload_after_save(local_path: str, s3_dir: str, blocking_save: bool, client=None,
                      endpoint_url: Optional[str] = None) -> None:
    """The trainer's upload: at once after a blocking save; after an async
    one (core/checkpoint.py, blocking=False), on a thread that first waits
    for that save's write to land, so the training loop keeps stepping
    through the write and the upload.  wait_for_uploads() joins it."""
    if blocking_save:
        upload_checkpoint(local_path, s3_dir, client, endpoint_url)
        return
    from egom2p_torch.core.checkpoint import save_in_flight
    writing = save_in_flight()

    def run():
        try:
            if writing is not None:
                writing.join()
            upload_checkpoint(local_path, s3_dir, client, endpoint_url)
        except BaseException as e:  # raised again by wait_for_uploads
            _UPLOAD_ERRORS.append(e)

    t = threading.Thread(target=run, name=f"upload {os.path.basename(local_path)}")
    t.start()
    _UPLOAD_THREADS.append(t)


def wait_for_uploads() -> None:
    """Join the uploads in flight (before the process exits); raises what
    an upload raised."""
    while _UPLOAD_THREADS:
        _UPLOAD_THREADS.pop().join()
    if _UPLOAD_ERRORS:
        raise _UPLOAD_ERRORS.pop()


def _list_keys(client, bucket: str, prefix: str) -> List[str]:
    """Every object key under `prefix`, through list_objects_v2's pages."""
    keys: List[str] = []
    token = None
    while True:
        kw = dict(Bucket=bucket, Prefix=prefix)
        if token:
            kw["ContinuationToken"] = token
        resp = client.list_objects_v2(**kw)
        keys += [o["Key"] for o in resp.get("Contents", [])]
        if not resp.get("IsTruncated"):
            return sorted(keys)
        token = resp.get("NextContinuationToken")
