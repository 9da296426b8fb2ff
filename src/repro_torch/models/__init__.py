from repro_torch.models.small import (accuracy, make_cifar_cnn,
                                     make_mnist_mlp, nll_loss)
