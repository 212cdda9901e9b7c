from repro_torch.train.step import (GraphedDecodeStep, TrainState,
                                    cross_entropy, init_train_state,
                                    make_decode_step, make_loss_fn,
                                    make_prefill_step, make_train_step)

__all__ = ["GraphedDecodeStep", "TrainState", "cross_entropy",
           "init_train_state", "make_decode_step", "make_loss_fn",
           "make_prefill_step", "make_train_step"]
