from repro_torch.train.loop import TrainState, init_state, make_train_step, train_loop
