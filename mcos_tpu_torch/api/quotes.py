"""Market quote service: live proxy with offline fallback (counterpart of
`mcos_tpu/api/quotes.py`, host `urllib`, copied unchanged apart from the
logger's name).

A Yahoo Finance v8 chart proxy plus a static NIFTY universe:

- `fetch_live_quote(symbol)`: GET Yahoo's 1-year daily chart for SYMBOL.NS,
  return last close, annualized realized vol from log-return stddev (×√245,
  the reference's day-count at server.js:69-80), name, 52-week hi/lo.
- `fetch_quote(symbol)`: live quote, falling back to the static universe when
  the network is unreachable — the graceful-degradation contract the
  dashboard relies on ('CACHED' badge on the static price and vol).
"""

from __future__ import annotations

import json
import logging
import math
import urllib.error
import urllib.request
from typing import Dict, Optional

logger = logging.getLogger("mcos_tpu_torch.quotes")

YAHOO_URL = ("https://query1.finance.yahoo.com/v8/finance/chart/"
             "{symbol}.NS?interval=1d&range=1y")
TRADING_DAYS = 245  # reference's annualization day-count (server.js:79)

# Static NIFTY-50 universe: sector + typical price/vol for offline operation
# (role of js/stocks.js:2-68). Full 50-constituent list matching the
# reference universe (js/stocks.js:2-53) plus the index itself; prices are
# approximate INR levels for demo mode, refreshed by any live quote that
# succeeds. Symbol/sector/vol entries are factual market metadata.
NIFTY50: Dict[str, Dict] = {
    "NIFTY": {"name": "NIFTY 50 Index", "sector": "Index", "price": 22500.0, "vol": 0.14},
    "RELIANCE": {"name": "Reliance Industries", "sector": "Energy", "price": 1285.0, "vol": 0.26},
    "TCS": {"name": "Tata Consultancy Services", "sector": "IT", "price": 3780.0, "vol": 0.22},
    "HDFCBANK": {"name": "HDFC Bank", "sector": "Banking", "price": 1640.0, "vol": 0.24},
    "ICICIBANK": {"name": "ICICI Bank", "sector": "Banking", "price": 1220.0, "vol": 0.28},
    "INFY": {"name": "Infosys", "sector": "IT", "price": 1870.0, "vol": 0.25},
    "BHARTIARTL": {"name": "Bharti Airtel", "sector": "Telecom", "price": 1710.0, "vol": 0.30},
    "ITC": {"name": "ITC Limited", "sector": "FMCG", "price": 415.0, "vol": 0.22},
    "KOTAKBANK": {"name": "Kotak Mahindra Bank", "sector": "Banking", "price": 1870.0, "vol": 0.25},
    "LT": {"name": "Larsen & Toubro", "sector": "Engineering", "price": 3450.0, "vol": 0.27},
    "HINDUNILVR": {"name": "Hindustan Unilever", "sector": "FMCG", "price": 2320.0, "vol": 0.20},
    "AXISBANK": {"name": "Axis Bank", "sector": "Banking", "price": 1050.0, "vol": 0.30},
    "SBIN": {"name": "State Bank of India", "sector": "Banking", "price": 770.0, "vol": 0.32},
    "BAJFINANCE": {"name": "Bajaj Finance", "sector": "NBFC", "price": 6950.0, "vol": 0.35},
    "MARUTI": {"name": "Maruti Suzuki India", "sector": "Auto", "price": 11200.0, "vol": 0.26},
    "HCLTECH": {"name": "HCL Technologies", "sector": "IT", "price": 1720.0, "vol": 0.24},
    "SUNPHARMA": {"name": "Sun Pharmaceutical", "sector": "Pharma", "price": 1790.0, "vol": 0.28},
    "ADANIPORTS": {"name": "Adani Ports & SEZ", "sector": "Infrastructure", "price": 1165.0, "vol": 0.38},
    "TATAMOTORS": {"name": "Tata Motors", "sector": "Auto", "price": 690.0, "vol": 0.40},
    "TITAN": {"name": "Titan Company", "sector": "Consumer", "price": 3320.0, "vol": 0.29},
    "WIPRO": {"name": "Wipro", "sector": "IT", "price": 310.0, "vol": 0.26},
    "ULTRACEMCO": {"name": "UltraTech Cement", "sector": "Cement", "price": 11400.0, "vol": 0.25},
    "NTPC": {"name": "NTPC Limited", "sector": "Power", "price": 335.0, "vol": 0.28},
    "POWERGRID": {"name": "Power Grid Corporation", "sector": "Power", "price": 295.0, "vol": 0.25},
    "TATASTEEL": {"name": "Tata Steel", "sector": "Metals", "price": 150.0, "vol": 0.38},
    "JSWSTEEL": {"name": "JSW Steel", "sector": "Metals", "price": 965.0, "vol": 0.36},
    "HINDALCO": {"name": "Hindalco Industries", "sector": "Metals", "price": 640.0, "vol": 0.34},
    "ONGC": {"name": "Oil & Natural Gas Corporation", "sector": "Energy", "price": 260.0, "vol": 0.30},
    "DRREDDY": {"name": "Dr. Reddy's Laboratories", "sector": "Pharma", "price": 1195.0, "vol": 0.28},
    "CIPLA": {"name": "Cipla", "sector": "Pharma", "price": 1490.0, "vol": 0.27},
    "GRASIM": {"name": "Grasim Industries", "sector": "Diversified", "price": 2530.0, "vol": 0.26},
    "NESTLEIND": {"name": "Nestle India", "sector": "FMCG", "price": 2250.0, "vol": 0.19},
    "BRITANNIA": {"name": "Britannia Industries", "sector": "FMCG", "price": 5180.0, "vol": 0.22},
    "DIVISLAB": {"name": "Divi's Laboratories", "sector": "Pharma", "price": 5250.0, "vol": 0.30},
    "APOLLOHOSP": {"name": "Apollo Hospitals Enterprise", "sector": "Healthcare", "price": 6740.0, "vol": 0.32},
    "BAJAJ-AUTO": {"name": "Bajaj Auto", "sector": "Auto", "price": 8750.0, "vol": 0.23},
    "BAJAJFINSV": {"name": "Bajaj Finserv", "sector": "NBFC", "price": 1680.0, "vol": 0.32},
    "EICHERMOT": {"name": "Eicher Motors", "sector": "Auto", "price": 5180.0, "vol": 0.27},
    "HEROMOTOCO": {"name": "Hero MotoCorp", "sector": "Auto", "price": 4180.0, "vol": 0.24},
    "HDFCLIFE": {"name": "HDFC Life Insurance", "sector": "Insurance", "price": 625.0, "vol": 0.26},
    "SBILIFE": {"name": "SBI Life Insurance", "sector": "Insurance", "price": 1565.0, "vol": 0.27},
    "SHRIRAMFIN": {"name": "Shriram Finance", "sector": "NBFC", "price": 580.0, "vol": 0.34},
    "INDUSINDBK": {"name": "IndusInd Bank", "sector": "Banking", "price": 990.0, "vol": 0.33},
    "ASIANPAINT": {"name": "Asian Paints", "sector": "Consumer", "price": 2290.0, "vol": 0.22},
    "BPCL": {"name": "Bharat Petroleum Corporation", "sector": "Energy", "price": 285.0, "vol": 0.33},
    "COALINDIA": {"name": "Coal India", "sector": "Mining", "price": 390.0, "vol": 0.28},
    "ADANIENT": {"name": "Adani Enterprises", "sector": "Conglomerate", "price": 2435.0, "vol": 0.45},
    "LTIM": {"name": "LTIMindtree", "sector": "IT", "price": 4960.0, "vol": 0.29},
    "TATACONSUM": {"name": "Tata Consumer Products", "sector": "FMCG", "price": 918.0, "vol": 0.27},
    "TECHM": {"name": "Tech Mahindra", "sector": "IT", "price": 1580.0, "vol": 0.30},
    "UPL": {"name": "UPL Limited", "sector": "Agrochemicals", "price": 520.0, "vol": 0.35},
}


def list_symbols() -> list:
    """Full universe for the UI's searchable picker (js/app.js:67-124 role):
    one row per symbol with the metadata the dropdown filters on."""
    return [{"symbol": sym, **info} for sym, info in NIFTY50.items()]


def get_stock_by_symbol(symbol: str) -> Optional[Dict]:
    """Universe lookup (js/stocks.js:70-72 role)."""
    return NIFTY50.get(symbol.upper())


def get_fallback_price(symbol: str) -> Optional[float]:
    """Offline price lookup (js/stocks.js:74-76 role)."""
    info = NIFTY50.get(symbol.upper())
    return info["price"] if info else None


def realized_vol_from_closes(closes, annualize: int = TRADING_DAYS) -> float:
    """Annualized σ from daily log returns (server.js:69-80 semantics)."""
    closes = [c for c in closes if c is not None and c > 0]
    if len(closes) < 3:
        return float("nan")
    rets = [math.log(b / a) for a, b in zip(closes, closes[1:])]
    mean = sum(rets) / len(rets)
    var = sum((x - mean) ** 2 for x in rets) / len(rets)
    return math.sqrt(var) * math.sqrt(annualize)


def fetch_live_quote(symbol: str, timeout: float = 5.0) -> Optional[Dict]:
    """Yahoo Finance v8 chart proxy (server.js:34-100 semantics).

    Returns None on any network/parse failure (graceful degradation).
    """
    url = YAHOO_URL.format(symbol=symbol.upper())
    try:
        req = urllib.request.Request(url, headers={"User-Agent": "mcos-tpu"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            data = json.loads(resp.read())
        result = data["chart"]["result"][0]
        meta = result["meta"]
        closes = result["indicators"]["quote"][0]["close"]
        closes = [c for c in closes if c]
        price = meta.get("regularMarketPrice") or closes[-1]
        return {
            "symbol": symbol.upper(),
            "price": float(price),
            "volatility": realized_vol_from_closes(closes),
            "name": meta.get("longName") or meta.get("shortName")
            or symbol.upper(),
            "high52": float(max(closes)),
            "low52": float(min(closes)),
            "source": "LIVE",
        }
    except (urllib.error.URLError, OSError, KeyError, IndexError,
            ValueError) as e:
        logger.warning("live quote for %s failed: %s", symbol, e)
        return None


def fetch_quote(symbol: str) -> Optional[Dict]:
    """Live quote with static-universe fallback (js/app.js:126-142 contract:
    the caller renders `source: CACHED` as the offline badge)."""
    live = fetch_live_quote(symbol)
    if live is not None:
        return live
    info = get_stock_by_symbol(symbol)
    if info is None:
        return None
    return {
        "symbol": symbol.upper(),
        "price": info["price"],
        "volatility": info["vol"],
        "name": info["name"],
        "high52": info["price"] * 1.15,
        "low52": info["price"] * 0.85,
        "source": "CACHED",
    }
