from repro_torch.training.optimizer import (AdamWConfig, adamw_init,  # noqa: F401
                                            adamw_update)
from repro_torch.training.train_loop import (TrainConfig,  # noqa: F401
                                             init_train_state,
                                             make_train_step, train)
