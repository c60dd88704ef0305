"""Pedigree utilities (counterpart of `gmat_tpu/pedigree/pedigree.py`, the
reference's `gmat/pedigree/process_pedigree.py`).

Host code on text files, no tensor work.  File contracts:
`.trace`, `.error1/.error2/.correct`, `.sort`, `.recode` + `.dct`, `.pec` +
`.prune`.  Missing parents are "0".
"""
from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def _read_ped(ped_file):
    """id -> [sire, dam], every mentioned id present with a default."""
    ped = {}
    with open(ped_file) as fin:
        rows = [line.split() for line in fin if line.strip()]
    for arr in rows:
        for key in arr[:3]:
            ped.setdefault(key, ["0", "0"])
    for arr in rows:
        ped[arr[0]] = [arr[1], arr[2]]
    ped.pop("0", None)
    return ped, rows


def ped_trace(id_file: str, full_ped_file: str, gen: int = 1000000) -> int:
    """Trace ancestors of the ids in id_file through the full pedigree;
    writes `<id_file>.trace` (reference :3-76)."""
    with open(id_file) as fin:
        ids = [line.split()[0] for line in fin if line.strip()]
    if "0" in ids:
        raise ValueError("0 is not allowed for id")
    ped, _ = _read_ped(full_ped_file)
    known = set(ids)
    frontier = set(ids)
    newly_added: set = set()
    for _ in range(gen):
        parents = set()
        for i in frontier:
            if i in ped:
                parents.update(p for p in ped[i] if p != "0")
        newly = parents - known
        if not newly:
            newly_added = newly
            break
        newly_added = newly
        known |= newly
        frontier = newly
    with open(id_file + ".trace", "w") as fout:
        for i in known:
            if i in newly_added or i not in ped:
                fout.write(f"{i}\t0\t0\n")
            else:
                fout.write(f"{i}\t{ped[i][0]}\t{ped[i][1]}\n")
    return len(known)


def ped_correct(ped_file: str) -> dict:
    """Fix ids appearing as both sire and dam (keep the more frequent role)
    and break ancestor cycles; writes `.error1`, `.error2`, `.correct`
    (reference :79-196)."""
    sire_count: dict = {}
    dam_count: dict = {}
    with open(ped_file) as fin:
        rows = [line.split() for line in fin if line.strip()]
    for arr in rows:
        sire_count[arr[1]] = sire_count.get(arr[1], 0) + 1
        dam_count[arr[2]] = dam_count.get(arr[2], 0) + 1
    overlap = (set(sire_count) & set(dam_count)) - {"0"}
    sire_del = {v for v in overlap if sire_count[v] < dam_count[v]}
    dam_del = overlap - sire_del
    ped: dict = {}
    for arr in rows:
        ped.setdefault(arr[1], ["0", "0"])
        ped.setdefault(arr[2], ["0", "0"])
    with open(ped_file + ".error1", "w") as fout:
        for arr in rows:
            if arr[1] in sire_del:
                fout.write("\t".join(arr[:3]) + "\n")
                arr[1] = "0"
            if arr[2] in dam_del:
                fout.write("\t".join(arr[:3]) + "\n")
                arr[2] = "0"
            ped[arr[0]] = [arr[1], arr[2]]
    ped.pop("0", None)

    def ancestors(i):
        anc = set()
        stack = [p for p in ped.get(i, ["0", "0"]) if p != "0"]
        while stack:
            a = stack.pop()
            if a in anc:
                continue
            anc.add(a)
            stack.extend(p for p in ped.get(a, ["0", "0"]) if p != "0")
        return anc

    with open(ped_file + ".error2", "w") as fout:
        for i in list(ped):
            anc = ancestors(i)
            if i in anc:
                fout.write(f"{i}\t{ped[i][0]}\t{ped[i][1]}\n")
                for j in anc:
                    if ped.get(j, ["", ""])[0] == i:
                        fout.write(f"{j}\t{ped[j][0]}\t{ped[j][1]}\n")
                        ped[j][0] = "0"
                    if ped.get(j, ["", ""])[1] == i:
                        fout.write(f"{j}\t{ped[j][0]}\t{ped[j][1]}\n")
                        ped[j][1] = "0"
    with open(ped_file + ".correct", "w") as fout:
        for i, (s, d) in ped.items():
            fout.write(f"{i}\t{s}\t{d}\n")
    return ped


def ped_sort(ped_file: str) -> int:
    """Topological sort (parents before offspring); writes `.sort`
    (reference :199-251)."""
    ped, _ = _read_ped(ped_file)
    done = {"0"}
    remaining = dict(ped)
    with open(ped_file + ".sort", "w") as fout:
        while remaining:
            progressed = False
            for i in list(remaining):
                s, d = remaining[i]
                if s in done and d in done:
                    fout.write(f"{i}\t{s}\t{d}\n")
                    done.add(i)
                    remaining.pop(i)
                    progressed = True
            if not progressed:
                raise ValueError(
                    "pedigree contains a cycle; run ped_correct first"
                )
    return 0


def ped_recode(ped_file: str) -> int:
    """Integer-recode ids (first column first, then parents); writes
    `.recode` and `.dct` (reference :254-304)."""
    code = {"0": 0}
    with open(ped_file) as fin:
        rows = [line.split() for line in fin if line.strip()]
    for arr in rows:
        if arr[0] not in code:
            code[arr[0]] = len(code)
    with open(ped_file + ".recode", "w") as fout:
        for arr in rows:
            for key in (arr[1], arr[2]):
                if key not in code:
                    code[key] = len(code)
            fout.write(f"{code[arr[0]]}\t{code[arr[1]]}\t{code[arr[2]]}\n")
    with open(ped_file + ".dct", "w") as fout:
        for key, val in code.items():
            if key != "0":
                fout.write(f"{key}\t{val}\n")
    return 0


def ped_completeness(ped_file: str, gen: int = 5, cut: float = 0.8) -> int:
    """MacCluer pedigree-completeness index and pruning; writes `.pec` and
    `.prune` (reference :307-396, citing MacCluer et al. 1983)."""
    ped, _ = _read_ped(ped_file)
    output: dict = {}
    with open(ped_file + ".pec", "w") as fout:
        for i in ped:
            s0, d0 = ped[i]
            if s0 == "0" or d0 == "0":
                continue
            sire1, dam1 = [s0], [d0]
            anc_lst = [s0, d0]
            pec_sire = pec_dam = 0.5
            for val in range(2, gen + 1):
                sire2, dam2 = [], []
                for pid in sire1:
                    for par in ped.get(pid, ["0", "0"]):
                        if par != "0":
                            pec_sire += 1.0 / 2**val
                            sire2.append(par)
                for pid in dam1:
                    for par in ped.get(pid, ["0", "0"]):
                        if par != "0":
                            pec_dam += 1.0 / 2**val
                            dam2.append(par)
                sire1, dam1 = sire2, dam2
                anc_lst.extend(sire1)
                anc_lst.extend(dam1)
            pec_sire /= gen
            pec_dam /= gen
            pec_val = 4 * pec_sire * pec_dam / (pec_sire + pec_dam)
            if pec_val > cut:
                fout.write(f"{i}\t{pec_val:f}\n")
                output[i] = list(ped[i])
                last_gen = set(sire1) | set(dam1)
                for a in anc_lst:
                    output[a] = ["0", "0"] if a in last_gen else list(
                        ped.get(a, ["0", "0"])
                    )
    with open(ped_file + ".prune", "w") as fout:
        for i, (s, d) in output.items():
            fout.write(f"{i}\t{s}\t{d}\n")
    return 0
