"""The roofline of a step: its op counts (``hlo_cost``), the card's terms
(``analysis``) and where its bytes go (``breakdown``)."""
