"""k-fold cross-validation splitting (ref: e2/.../evaluation/CrossValidation.scala:20).

Copy of ``predictionio_tpu/core/cross_validation.py``. Behavior
contract: ``split_data`` divides a dataset into ``eval_k`` folds where
fold *i*'s test set is the points whose index satisfies
``idx % eval_k == i`` and its training set is everything else
(CommonHelperFunctions.splitData :33-62). Each fold yields
``(training_data, evaluator_info, [(query, actual), ...])`` — the
shape DataSource.read_eval returns to the evaluation harness.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

D = TypeVar("D")
TD = TypeVar("TD")
EI = TypeVar("EI")
Q = TypeVar("Q")
A = TypeVar("A")


def split_data(
    eval_k: int,
    dataset: Sequence[D],
    evaluator_info: EI,
    training_data_creator: Callable[[List[D]], TD],
    query_creator: Callable[[D], Q],
    actual_creator: Callable[[D], A],
) -> List[Tuple[TD, EI, List[Tuple[Q, A]]]]:
    if eval_k < 1:
        raise ValueError("eval_k must be >= 1")
    folds = []
    for fold_idx in range(eval_k):
        training = [d for i, d in enumerate(dataset) if i % eval_k != fold_idx]
        testing = [d for i, d in enumerate(dataset) if i % eval_k == fold_idx]
        folds.append((
            training_data_creator(training),
            evaluator_info,
            [(query_creator(d), actual_creator(d)) for d in testing],
        ))
    return folds
