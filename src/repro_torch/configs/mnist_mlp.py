"""The paper's MNIST model (§V): 4-layer MLP with ReLU, log-softmax head."""
config = {
    "kind": "mnist_mlp",
    "input_hw": (28, 28, 1),
    "hidden": (200, 100, 64),
    "num_classes": 10,
    "batch_size": 64,     # paper
    "lr": 1e-3,           # paper
    "clients": 50,        # paper
    "noniid_shards_per_client": 4,
}
