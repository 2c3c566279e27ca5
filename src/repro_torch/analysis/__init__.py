"""Static cost models: the LM zoo's analytic FLOP / HBM-byte model, the
GCN layer ordering, the layout report and the split-phase overlap
report."""
from repro_torch.analysis.cost import (analytic_cost, choose_gcn_orders,
                                       graph_layout_report, param_count,
                                       split_overlap_report)

__all__ = ["analytic_cost", "param_count", "choose_gcn_orders",
           "graph_layout_report", "split_overlap_report"]
