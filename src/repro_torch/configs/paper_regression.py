"""The paper's own reference scenario (Sec. VI): distributed linear
regression via DGD with h(X_i) = X_i X_i^T theta, at the EC2 sizes of
Fig. 5."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RegressionConfig:
    N: int = 900          # samples (paper Fig. 5)
    d: int = 400          # features
    n: int = 15           # workers / tasks
    r: int = 3            # computation load
    k: int = 15           # computation target
    lr: float = 0.01      # paper's constant learning rate
    iterations: int = 500
    schedule: str = "ss"


def config() -> RegressionConfig:
    return RegressionConfig()
