"""The paper's CIFAR model (§V): 6-layer CNN (3×64, 64×120, 120×200 convs
with 2×2 max-pool, log-softmax head)."""
config = {
    "kind": "cifar_cnn",
    "input_hw": (32, 32, 3),
    "num_classes": 10,
    "batch_size": 32,     # paper
    "lr": 1e-3,           # paper
    "clients": 27,        # paper
    "noniid_shards_per_client": 7,
}
