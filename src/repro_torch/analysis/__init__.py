"""Static cost model of the GCN layer ordering, and the layout report."""
from repro_torch.analysis.cost import choose_gcn_orders, graph_layout_report

__all__ = ["choose_gcn_orders", "graph_layout_report"]
