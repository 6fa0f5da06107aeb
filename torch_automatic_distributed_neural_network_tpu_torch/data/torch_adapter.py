"""torch ``Dataset`` / ``DataLoader`` adapters, the port of the JAX
package's ``data/torch_adapter.py``: a user keeps their
``torch.utils.data`` pipeline and the port takes its batches as numpy
dicts, as every data source of the port yields them.

- :class:`TorchDatasetAdapter` wraps a map-style ``Dataset`` (anything
  with ``__len__`` and ``__getitem__``) into the step-indexed protocol
  (``step_indexed = True``, ``batch(i)``): a permutation a epoch keyed
  by (seed, epoch), so a resumed run sees exactly the batches an
  uninterrupted one would.  It takes ``DistributedSampler``'s place:
  every process builds the same global batch and
  ``AutoDistribute.shard_batch`` keeps its rows.
- :class:`TorchLoaderAdapter` wraps an iterable ``DataLoader`` (or any
  iterable of batches) as an iterable of numpy dict batches, for
  pipelines whose sampling lives in the loader.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from .arrays import _epoch_order


def to_numpy_tree(x: Any) -> Any:
    """torch tensors -> numpy, recursively through dicts, lists, tuples
    and namedtuples."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # namedtuple
        return type(x)(*(to_numpy_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy_tree(v) for v in x)
    return x


def default_collate(items: Sequence[Any]) -> dict:
    """Stack per-example items into a dict batch: dict items ->
    ``{key: stacked}``; ``(x, y)`` pairs (torch's classification
    convention) -> ``{"x", "label"}``, the classification losses' keys;
    a single array -> ``{"x"}``."""
    first = to_numpy_tree(items[0])
    items = [to_numpy_tree(i) for i in items]
    if isinstance(first, dict):
        return {k: np.stack([i[k] for i in items]) for k in first}
    if isinstance(first, (list, tuple)):
        if len(first) != 2:
            raise ValueError(
                f"default_collate handles (x, y) pairs; got "
                f"{len(first)}-tuples — pass an explicit collate=")
        return {"x": np.stack([i[0] for i in items]),
                "label": np.stack([np.asarray(i[1]) for i in items])}
    return {"x": np.stack(items)}


class TorchDatasetAdapter:
    """Map-style torch ``Dataset`` -> step-indexed batch source.

    ``batch(step)`` draws batch ``step % steps_per_epoch`` of epoch
    ``step // steps_per_epoch`` under a permutation keyed by (seed,
    epoch), the array sources' scheme (``arrays._epoch_order``):
    stateless, so a resume replays the exact batch sequence.  A short
    last batch is dropped (``drop_last``, as ``DistributedSampler``)."""

    step_indexed = True

    def __init__(self, dataset: Any, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0,
                 collate: Callable[[Sequence[Any]], dict] | None = None):
        n = len(dataset)
        if batch_size > n:
            raise ValueError(f"batch_size {batch_size} > dataset size {n}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.collate = collate or default_collate
        self.steps_per_epoch = n // batch_size
        self._perm_cache: tuple[int, np.ndarray] | None = None

    def _perm(self, epoch: int) -> np.ndarray:
        """The epoch's order, cached for the epoch (a permutation a batch
        would be O(n) host work on the data path)."""
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        if self._perm_cache is None or self._perm_cache[0] != epoch:
            self._perm_cache = (epoch, _epoch_order(n, epoch, self.seed))
        return self._perm_cache[1]

    def batch(self, step: int) -> dict:
        epoch, k = divmod(step, self.steps_per_epoch)
        idx = self._perm(epoch)[k * self.batch_size:(k + 1) * self.batch_size]
        return self.collate([self.dataset[int(j)] for j in idx])

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class TorchLoaderAdapter:
    """Iterable ``DataLoader`` (or any batch iterable) -> iterable of
    numpy dict batches; re-iterable when the loader is.  Tensors move to
    the host as numpy, and ``(x, y)`` pairs become ``{"x", "label"}``."""

    step_indexed = False

    def __init__(self, loader: Any):
        self.loader = loader

    def __iter__(self):
        for batch in self.loader:
            b = to_numpy_tree(batch)
            if isinstance(b, dict):
                yield b
            elif isinstance(b, (list, tuple)):
                if len(b) != 2:
                    raise ValueError(
                        f"TorchLoaderAdapter maps (x, y) pairs to "
                        f"{{'x', 'label'}}; got a {len(b)}-tuple — wrap "
                        f"your loader to yield dicts instead")
                yield {"x": np.asarray(b[0]), "label": np.asarray(b[1])}
            else:
                yield {"x": np.asarray(b)}
