"""Cross-process collectives for metric sync (:mod:`.dist_env`); the JAX
package's ``AxisEnv`` has no counterpart (see :mod:`.dist_env`)."""
from metrics_tpu_torch.parallel.dist_env import DistEnv, NoOpEnv, ProcessEnv, default_env  # noqa: F401
from metrics_tpu_torch.utilities.distributed import gather_all_tensors  # noqa: F401
