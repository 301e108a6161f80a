"""The paper's own classification tasks on the port: the harness and the
Table 2 / Tables 4-6 / Figure 2 scripts (``python -m
repro_torch.paper_tasks.{cifar_like,tasks,ablation} [--device cpu]``)."""
