"""`cubercnn://` model-zoo names (weakcube_tpu/utils/model_zoo.py, after the
reference's cubercnn/util/model_zoo.py): a name maps onto a path under
https://dl.fbaipublicfiles.com/cubercnn/, cached in a local directory.
Fetching needs network access; without it, place the file in the cache and
the name resolves all the same.
"""
from __future__ import annotations

import os

PREFIX = "cubercnn://"
BASE_URL = "https://dl.fbaipublicfiles.com/cubercnn/"
CACHE_DIR = os.path.expanduser("~/.cache/weakcube_tpu/zoo")


def resolve(uri: str) -> str:
    """cubercnn://path -> the cached local file, fetched first when it is
    not cached; other names pass through."""
    if not uri.startswith(PREFIX):
        return uri
    rel = uri[len(PREFIX):]
    local = os.path.join(CACHE_DIR, rel)
    if os.path.exists(local):
        return local
    url = BASE_URL + rel
    try:
        import urllib.request
        os.makedirs(os.path.dirname(local), exist_ok=True)
        urllib.request.urlretrieve(url, local)
        return local
    except Exception as e:  # no network access
        raise FileNotFoundError(
            f"cannot fetch {url} (no network access?); place the file at {local}") from e
