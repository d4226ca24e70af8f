"""Evaluation datasets (counterpart of
``audio_rag_tpu/evaluation/dataset.py``): ``EvalSample`` (question,
reference answer, relevance keywords), ``EvalDataset`` with JSON load and
save in the same layout, and the built-in 8-sample machine-learning-lecture
set.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path

__all__ = ["EvalSample", "EvalDataset", "CS229_EVAL_DATASET"]


@dataclass
class EvalSample:
    question: str
    reference_answer: str
    #: substrings whose presence marks a retrieved chunk as relevant
    relevance_keywords: list[str] = field(default_factory=list)
    metadata: dict = field(default_factory=dict)


@dataclass
class EvalDataset:
    name: str
    samples: list[EvalSample] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.samples)

    def __iter__(self):
        return iter(self.samples)

    def save(self, path: str | Path) -> None:
        with open(path, "w") as f:
            json.dump(
                {"name": self.name,
                 "samples": [asdict(s) for s in self.samples]},
                f, indent=2,
            )

    @classmethod
    def load(cls, path: str | Path) -> "EvalDataset":
        with open(path) as f:
            data = json.load(f)
        return cls(
            name=data.get("name", Path(path).stem),
            samples=[EvalSample(**s) for s in data["samples"]],
        )


CS229_EVAL_DATASET = EvalDataset(
    name="ml-lectures-8",
    samples=[
        EvalSample(
            question="What is gradient descent and how does the learning "
                     "rate affect convergence?",
            reference_answer="Gradient descent iteratively updates "
            "parameters in the direction of the negative gradient; the "
            "learning rate controls the step size — too large diverges, "
            "too small converges slowly.",
            relevance_keywords=["gradient descent", "learning rate",
                                "converge"],
        ),
        EvalSample(
            question="How does regularization reduce overfitting?",
            reference_answer="Regularization penalizes large weights, "
            "constraining model complexity so it generalizes instead of "
            "memorizing the training data.",
            relevance_keywords=["regularization", "overfitting", "penalty"],
        ),
        EvalSample(
            question="What is the difference between supervised and "
                     "unsupervised learning?",
            reference_answer="Supervised learning fits labeled "
            "input-output pairs; unsupervised learning finds structure in "
            "unlabeled data, like clustering.",
            relevance_keywords=["supervised", "unsupervised", "labels"],
        ),
        EvalSample(
            question="Why do we use a validation set separate from the "
                     "test set?",
            reference_answer="The validation set tunes hyperparameters; "
            "the test set gives an unbiased final estimate. Tuning on the "
            "test set leaks information.",
            relevance_keywords=["validation", "test set", "hyperparameter"],
        ),
        EvalSample(
            question="What does the kernel trick accomplish in SVMs?",
            reference_answer="The kernel trick computes inner products in "
            "a high-dimensional feature space implicitly, letting linear "
            "methods fit nonlinear boundaries without explicit mapping.",
            relevance_keywords=["kernel", "svm", "feature space"],
        ),
        EvalSample(
            question="How does backpropagation compute gradients in a "
                     "neural network?",
            reference_answer="Backpropagation applies the chain rule "
            "layer by layer from the loss backwards, reusing intermediate "
            "results to compute all parameter gradients efficiently.",
            relevance_keywords=["backpropagation", "chain rule", "gradient"],
        ),
        EvalSample(
            question="What is the bias-variance tradeoff?",
            reference_answer="Simple models underfit (high bias); complex "
            "models overfit (high variance). Generalization error is "
            "minimized by balancing the two.",
            relevance_keywords=["bias", "variance", "tradeoff"],
        ),
        EvalSample(
            question="When is logistic regression preferred over linear "
                     "regression?",
            reference_answer="For classification: logistic regression "
            "models class probabilities with a sigmoid, while linear "
            "regression is for continuous targets.",
            relevance_keywords=["logistic regression", "classification",
                                "sigmoid"],
        ),
    ],
)
