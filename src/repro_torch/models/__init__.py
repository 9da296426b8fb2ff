from repro_torch.models.small import accuracy, make_mnist_mlp, nll_loss
