"""Pairwise similarity and distance matrices between sets of row vectors:
port of ``metrics_tpu/functional/pairwise/metrics.py``.

The products are ``torch.matmul``, as the JAX package computes them with
``@`` outside any Pallas kernel. On the card a float32 product stays in
float32 unless the caller turns on TF32
(``torch.backends.cuda.matmul.allow_tf32``); nothing here turns it on.

The euclidean distance is ``sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0))``, as in
the JAX package: near the diagonal the terms cancel, so its absolute error
grows with the squared norms, not with the distance.

The manhattan distance broadcasts ``(N, M, D)``; here ``x``'s rows go in
blocks that keep that intermediate under :data:`MANHATTAN_BLOCK_BYTES`.
Each element is still one sum over ``D`` of the same terms.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

MANHATTAN_BLOCK_BYTES = 1 << 30


def _check_input(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tuple[Tensor, Tensor, bool]:
    """Validate the shapes; ``zero_diagonal`` defaults to True when ``y`` is omitted."""
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    """Reduce along the last dim."""
    if reduction == "mean":
        return distmat.mean(dim=-1)
    if reduction == "sum":
        return distmat.sum(dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _zero_diag(mat: Tensor, zero_diagonal: bool) -> Tensor:
    """``mat`` (a fresh result) with its main diagonal set to 0."""
    if zero_diagonal:
        mat.fill_diagonal_(0.0)
    return mat


def _pairwise_cosine_similarity_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    y = y / torch.linalg.norm(y, dim=1, keepdim=True)
    distance = x @ y.T
    return _zero_diag(distance, zero_diagonal)


def pairwise_cosine_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise cosine similarity.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_cosine_similarity
        >>> x = torch.tensor([[2.0, 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1.0, 0], [2, 1]])
        >>> pairwise_cosine_similarity(x, y).round(decimals=4)
        tensor([[0.5547, 0.8682],
                [0.5145, 0.8437],
                [0.5300, 0.8533]])
    """
    distance = _pairwise_cosine_similarity_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)


def _pairwise_euclidean_distance_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_norm = torch.linalg.norm(x, dim=1, keepdim=True)
    y_norm = torch.linalg.norm(y, dim=1)[None, :]
    distance = x_norm * x_norm + y_norm * y_norm - 2 * (x @ y.T)
    distance = _zero_diag(distance, zero_diagonal)
    return torch.sqrt(torch.clamp(distance, min=0.0))


def pairwise_euclidean_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise euclidean distance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_euclidean_distance
        >>> x = torch.tensor([[2.0, 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1.0, 0], [2, 1]])
        >>> pairwise_euclidean_distance(x, y).round(decimals=4)
        tensor([[3.1623, 2.0000],
                [5.3852, 4.1231],
                [8.9443, 7.6158]])
    """
    distance = _pairwise_euclidean_distance_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)


def _pairwise_linear_similarity_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distance = x @ y.T
    return _zero_diag(distance, zero_diagonal)


def pairwise_linear_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise inner-product similarity.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_linear_similarity
        >>> x = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
        >>> y = torch.tensor([[1.0, 1.0]])
        >>> pairwise_linear_similarity(x, y).ravel().tolist()
        [1.0, 1.0]
    """
    distance = _pairwise_linear_similarity_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)


def manhattan_block_rows(m: int, d: int, itemsize: int) -> int:
    """Rows of ``x`` a block of the manhattan broadcast takes: as many as keep
    its ``(rows, m, d)`` intermediate within :data:`MANHATTAN_BLOCK_BYTES`, at least one."""
    return max(1, MANHATTAN_BLOCK_BYTES // max(1, m * d * itemsize))


def _pairwise_manhattan_distance_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    rows = manhattan_block_rows(y.shape[0], x.shape[1], torch.promote_types(x.dtype, y.dtype).itemsize)
    blocks = [torch.abs(xb[:, None, :] - y[None, :, :]).sum(dim=-1) for xb in torch.split(x, rows)]
    distance = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
    return _zero_diag(distance, zero_diagonal)


def pairwise_manhattan_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise manhattan distance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_manhattan_distance
        >>> x = torch.tensor([[2.0, 3], [3, 5], [5, 8]])
        >>> y = torch.tensor([[1.0, 0], [2, 1]])
        >>> pairwise_manhattan_distance(x, y)
        tensor([[ 4.,  2.],
                [ 7.,  5.],
                [12., 10.]])
    """
    distance = _pairwise_manhattan_distance_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)
