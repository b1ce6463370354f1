"""Training for the recsys family: the optimizers (``optim``), the train
and serve step builders (``step``), the fault-tolerant loop (``loop``) and
int8 gradient compression (``compress``)."""
