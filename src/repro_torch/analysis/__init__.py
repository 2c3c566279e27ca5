"""Static cost model of the GCN layer ordering, the layout report and the
split-phase overlap report."""
from repro_torch.analysis.cost import (choose_gcn_orders, graph_layout_report,
                                       split_overlap_report)

__all__ = ["choose_gcn_orders", "graph_layout_report", "split_overlap_report"]
