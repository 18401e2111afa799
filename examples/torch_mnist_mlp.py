"""The paper's MNIST MLP trained by plain autograd, as the reference's
classifier examples train it: the synthetic MNIST surrogate, SGD at lr
0.1 on minibatches of 128, the mean negative log-likelihood of the
softmax. Shared by ``torch_quickstart.py``, ``torch_adaptive_serving.py``
and ``torch_workload_balancing.py``.

The reference initialises from ``jax.random.key(0)``, which PyTorch
cannot reproduce: here the weights come from a seeded
``torch.Generator`` unless the caller passes a starting list (the
reference's weights carried across by
``repro_torch.models.classifier.params_from_numpy``).

The reference jits its SGD step; on the card the step runs as one CUDA
graph (``repro_torch.train.graphs.DonatedStep``, the weights updated in
their own buffers), bitwise the eager step (``graphs=False``).
"""
import torch

from repro_torch.configs.classifier import MNIST_MLP
from repro_torch.data.pipeline import minibatches, synthetic_mnist
from repro_torch.models.classifier import classifier_forward, init_classifier
from repro_torch.train.graphs import DonatedStep


def train(params=None, *, n_train: int = 8192, n_test: int = 4096,
          steps: int = 400, batch: int = 128, lr: float = 0.1,
          device="cuda", seed: int = 0, graphs=None):
    """-> (trained params on ``device``, (x_test, y_test) as NumPy);
    ``graphs`` as ``DonatedStep`` takes it."""
    x_tr, y_tr, x_te, y_te = synthetic_mnist(n_train=n_train, n_test=n_test)
    if params is None:
        params = init_classifier(MNIST_MLP, torch.Generator(
            device=device).manual_seed(seed), device=device)

    def sgd(params, bx, by):
        live = [{k: v.detach().requires_grad_() for k, v in lp.items()}
                for lp in params]
        leaves = [t for lp in live for t in lp.values()]
        lg = classifier_forward(live, MNIST_MLP, bx)
        loss = -torch.mean(torch.log_softmax(lg, -1)[
            torch.arange(len(by), device=device), by.long()])
        grads = iter(torch.autograd.grad(loss, leaves))
        return ([{k: v.detach() - lr * next(grads) for k, v in lp.items()}
                 for lp in live],)

    step = DonatedStep(sgd, donate=1, graphs=graphs)
    state = [{k: v.detach().to(device, copy=True) for k, v in lp.items()}
             for lp in params]
    it = minibatches(x_tr, y_tr, batch, device=device)
    for _ in range(steps):
        state, = step(state, *next(it))
    return state, (x_te, y_te)


def accuracy(params, x, y) -> float:
    """Top-1 accuracy of the MLP on NumPy (x, y)."""
    device = params[0]["w"].device
    with torch.no_grad():
        pred = classifier_forward(params, MNIST_MLP, torch.from_numpy(
            x).to(device)).argmax(-1).cpu().numpy()
    return float((pred == y).mean())
