"""Word grouping (paper Sec. IV-C): unify provider label vocabularies.

The user supplies a template T (the 80 COCO categories).  A synonym dataset
(embedded WordNet-style synsets + the manual additions the paper describes)
seeds a union-find; every provider word is resolved to a canonical group
index, and words irrelevant to the template are discarded (index -1).
"""
from __future__ import annotations

from typing import Dict, Iterable, List

COCO_TEMPLATE: List[str] = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

# WordNet-style synsets restricted to the template, plus the manual
# additions the paper describes (Sec. IV-C: "we manually add the missing
# words within set A to the 80 groups").
SYNONYMS: Dict[str, List[str]] = {
    "person": ["human", "people", "pedestrian", "man", "woman"],
    "bicycle": ["bike", "cycle", "pushbike"],
    "car": ["automobile", "auto", "motorcar", "sedan"],
    "motorcycle": ["motorbike", "moped"],
    "airplane": ["aeroplane", "plane", "aircraft", "jet"],
    "bus": ["autobus", "coach", "omnibus"],
    "train": ["railway train", "locomotive"],
    "truck": ["lorry", "pickup truck", "van"],
    "boat": ["ship", "vessel", "watercraft"],
    "traffic light": ["traffic signal", "stoplight"],
    "fire hydrant": ["hydrant", "fireplug"],
    "stop sign": ["stop signal"],
    "bench": ["park bench"],
    "bird": ["fowl", "avian"],
    "cat": ["kitty", "house cat", "feline"],
    "dog": ["canine", "puppy", "hound"],
    "horse": ["pony", "equine"],
    "sheep": ["lamb", "ewe"],
    "cow": ["cattle", "ox", "bovine"],
    "elephant": ["pachyderm"],
    "bear": ["bruin"],
    "backpack": ["rucksack", "knapsack", "back pack"],
    "umbrella": ["parasol", "brolly"],
    "handbag": ["purse", "pocketbook", "bag"],
    "tie": ["necktie", "cravat"],
    "suitcase": ["luggage", "valise", "baggage"],
    "sports ball": ["ball", "football", "soccer ball"],
    "baseball bat": ["bat"],
    "baseball glove": ["mitt", "glove"],
    "tennis racket": ["racket", "racquet"],
    "bottle": ["flask", "water bottle"],
    "wine glass": ["wineglass", "goblet"],
    "cup": ["mug", "teacup", "coffee cup"],
    "bowl": ["basin", "dish"],
    "couch": ["sofa", "settee", "lounge"],
    "potted plant": ["houseplant", "pot plant", "plant"],
    "bed": ["mattress"],
    "dining table": ["table", "dinner table", "desk"],
    "toilet": ["lavatory", "commode", "wc"],
    "tv": ["television", "tvmonitor", "tv monitor", "telly"],
    "laptop": ["notebook computer", "laptop computer"],
    "mouse": ["computer mouse"],
    "remote": ["remote control", "clicker"],
    "keyboard": ["computer keyboard"],
    "cell phone": ["mobile phone", "cellphone", "smartphone", "phone"],
    "microwave": ["microwave oven"],
    "oven": ["stove", "cooker"],
    "sink": ["washbasin", "basin sink"],
    "refrigerator": ["fridge", "icebox"],
    "book": ["novel", "paperback"],
    "clock": ["timepiece", "wall clock"],
    "vase": ["urn"],
    "scissors": ["shears", "clippers"],
    "teddy bear": ["teddy", "plush bear", "stuffed bear"],
    "hair drier": ["hair dryer", "blow dryer"],
    "toothbrush": ["tooth brush"],
}


class _UnionFind:
    def __init__(self):
        self.parent: Dict[str, str] = {}

    def find(self, x: str) -> str:
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: str, b: str) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _norm(w: str) -> str:
    return " ".join(w.strip().lower().replace("-", " ").replace("_", " ")
                    .split())


class WordGrouper:
    """Maps arbitrary provider category names to canonical template ids."""

    def __init__(self, template: Iterable[str] = COCO_TEMPLATE,
                 synonyms: Dict[str, List[str]] = SYNONYMS,
                 manual_additions: Dict[str, str] | None = None):
        self.template = [_norm(t) for t in template]
        uf = _UnionFind()
        for t in self.template:
            uf.find(t)
        for canon, syns in synonyms.items():
            for s in syns:
                uf.union(_norm(canon), _norm(s))
        if manual_additions:
            for word, canon in manual_additions.items():
                uf.union(_norm(canon), _norm(word))
        self._uf = uf
        self._canon_index = {t: i for i, t in enumerate(self.template)}
        # resolve every known word to a template index
        self._cache: Dict[str, int] = {}
        for w in list(uf.parent):
            self._cache[w] = self._resolve(w)

    def _resolve(self, w: str) -> int:
        root = self._uf.find(w)
        # root may not be the template word itself; scan its class
        if root in self._canon_index:
            return self._canon_index[root]
        for t, i in self._canon_index.items():
            if self._uf.find(t) == root:
                return i
        return -1

    def to_group(self, word: str) -> int:
        """Canonical group id for a provider word, or -1 (discard)."""
        w = _norm(word)
        if w not in self._cache:
            if w in self._uf.parent:
                gid = self._resolve(w)
            else:
                # collapsed-form fallback: "motor bike" <-> "motorbike"
                collapsed = w.replace(" ", "")
                gid = -1
                for known in self._uf.parent:
                    if known.replace(" ", "") == collapsed:
                        gid = self._resolve(known)
                        break
            self._cache[w] = gid
        return self._cache[w]

    def group_all(self, words: Iterable[str]) -> List[int]:
        return [self.to_group(w) for w in words]

    @property
    def num_groups(self) -> int:
        return len(self.template)
