"""The paper's own workload trio (ResNet-V2 on image data, batch 32)."""
from repro_torch.configs.base import ModelConfig

def _resnet(name, stages, img, classes):
    return ModelConfig(
        name=name, family="resnet", n_layers=sum(stages) * 3 + 2,
        d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab=0,
        stages=stages, img_size=img, n_classes=classes, remat=False,
    )

RESNET_SMALL = _resnet("resnet_small", (2, 2, 2, 2), 32, 10)      # ResNet26-V2 / CIFAR-10
RESNET_MEDIUM = _resnet("resnet_medium", (3, 4, 6, 3), 64, 1000)  # ResNet50-V2 / ImageNet64
RESNET_LARGE = _resnet("resnet_large", (3, 8, 36, 3), 224, 1000)  # ResNet152-V2 / ImageNet
