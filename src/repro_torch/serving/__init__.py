from repro_torch.serving.engine import (ContinuousEngine, Request,  # noqa: F401
                                        ServingEngine, TorchExecutor,
                                        WaveEngine, bucket_len)
from repro_torch.serving.executor import (EngineExecutor,  # noqa: F401
                                          EngineExecutorConfig)
