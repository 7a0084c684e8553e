"""Per-language seed text for the character n-gram language identifier.

The reference whitelists corpus languages with the ``eld`` package
(``train/utils/dataloaders.py:44-50``, ~60 languages). With zero network
egress this repo owns the capability instead: each entry below is a small
sample of everyday text written for this project (newline-separated
sentences) from which ``yoho_tpu_torch.text.langdetect`` builds character
trigram profiles at import time. Codes follow the Whisper language table
(``text/whisper_tokens.py``). Adding a language = adding an entry here.

The samples are deliberately plain spoken/written prose: language
identification keys on function words and orthography, not topic.

The port's copy of the JAX package's ``text/lang_corpus.py``, which imports no JAX
(the port imports nothing of ``yoho_tpu``).
"""

CORPUS: dict[str, str] = {
    "en": """\
The weather was cold this morning, so we stayed inside and made some tea.
I think they are going to the market later, but nothing has been decided.
She told me that the keys were on the table next to the old photographs.
We have been waiting for the train for almost an hour now.
There is not much to say about it, except that it could have gone better.
When you get home, please remember to close the windows before it rains.
He would rather read a book in the evening than watch anything at all.
Most of the people in the village have known each other for many years.
Could you tell me where the nearest station is, please?
It was one of those days when everything seemed to happen at once.""",
    "de": """\
Das Wetter war heute Morgen sehr kalt, deshalb sind wir zu Hause geblieben.
Ich glaube, dass sie später auf den Markt gehen wollen, aber sicher ist nichts.
Sie hat mir gesagt, dass die Schlüssel auf dem Tisch neben den Fotos liegen.
Wir warten schon seit fast einer Stunde auf den Zug.
Es gibt nicht viel darüber zu sagen, außer dass es besser hätte laufen können.
Wenn du nach Hause kommst, vergiss bitte nicht, die Fenster zu schließen.
Er würde abends lieber ein Buch lesen, als irgendetwas zu schauen.
Die meisten Leute im Dorf kennen sich schon seit vielen Jahren.
Können Sie mir bitte sagen, wo der nächste Bahnhof ist?
Es war einer dieser Tage, an denen alles gleichzeitig zu passieren schien.""",
    "fr": """\
Il faisait très froid ce matin, alors nous sommes restés à la maison.
Je pense qu'ils iront au marché plus tard, mais rien n'est encore décidé.
Elle m'a dit que les clés étaient sur la table, à côté des vieilles photos.
Nous attendons le train depuis presque une heure maintenant.
Il n'y a pas grand-chose à dire, sauf que cela aurait pu mieux se passer.
Quand tu rentreras, n'oublie pas de fermer les fenêtres avant la pluie.
Il préférerait lire un livre le soir plutôt que de regarder quoi que ce soit.
La plupart des gens du village se connaissent depuis de nombreuses années.
Pouvez-vous me dire où se trouve la gare la plus proche, s'il vous plaît ?
C'était une de ces journées où tout semblait arriver en même temps.""",
    "es": """\
Hacía mucho frío esta mañana, así que nos quedamos en casa tomando té.
Creo que irán al mercado más tarde, pero todavía no hay nada decidido.
Me dijo que las llaves estaban sobre la mesa, junto a las fotos viejas.
Llevamos casi una hora esperando el tren.
No hay mucho que decir, salvo que podría haber salido mejor.
Cuando llegues a casa, acuérdate de cerrar las ventanas antes de que llueva.
Él preferiría leer un libro por la noche antes que ver cualquier cosa.
La mayoría de la gente del pueblo se conoce desde hace muchos años.
¿Me puede decir dónde está la estación más cercana, por favor?
Fue uno de esos días en los que todo parecía pasar al mismo tiempo.""",
    "it": """\
Faceva molto freddo stamattina, quindi siamo rimasti a casa a bere il tè.
Penso che andranno al mercato più tardi, ma non è stato ancora deciso nulla.
Mi ha detto che le chiavi erano sul tavolo, accanto alle vecchie fotografie.
Stiamo aspettando il treno da quasi un'ora ormai.
Non c'è molto da dire, se non che sarebbe potuta andare meglio.
Quando torni a casa, ricordati di chiudere le finestre prima che piova.
La sera preferirebbe leggere un libro piuttosto che guardare qualcosa.
La maggior parte delle persone del paese si conosce da molti anni.
Mi può dire dov'è la stazione più vicina, per favore?
Era una di quelle giornate in cui tutto sembrava succedere insieme.""",
    "pt": """\
Estava muito frio esta manhã, por isso ficámos em casa a beber chá.
Acho que eles vão ao mercado mais tarde, mas ainda não há nada decidido.
Ela disse-me que as chaves estavam na mesa, ao lado das fotografias antigas.
Estamos à espera do comboio há quase uma hora.
Não há muito a dizer, a não ser que podia ter corrido melhor.
Quando chegares a casa, lembra-te de fechar as janelas antes da chuva.
Ele preferia ler um livro à noite do que ver seja o que for.
A maioria das pessoas da aldeia conhece-se há muitos anos.
Pode dizer-me onde fica a estação mais próxima, por favor?
Foi um daqueles dias em que tudo parecia acontecer ao mesmo tempo.""",
    "nl": """\
Het was vanochtend erg koud, dus we zijn binnen gebleven met een kop thee.
Ik denk dat ze later naar de markt gaan, maar er is nog niets besloten.
Ze vertelde me dat de sleutels op de tafel lagen, naast de oude foto's.
We wachten nu al bijna een uur op de trein.
Er valt niet veel over te zeggen, behalve dat het beter had gekund.
Als je thuiskomt, vergeet dan niet de ramen te sluiten voordat het regent.
Hij zou 's avonds liever een boek lezen dan iets te kijken.
De meeste mensen in het dorp kennen elkaar al vele jaren.
Kunt u mij zeggen waar het dichtstbijzijnde station is?
Het was zo'n dag waarop alles tegelijk leek te gebeuren.
Heb je gezien dat het gisteren de hele dag heeft geregend? Ik ben niet naar buiten geweest.
Zij heeft de hele middag in de tuin gewerkt, omdat het eindelijk mooi weer was.""",
    "sv": """\
Det var väldigt kallt i morse, så vi stannade inne och drack te.
Jag tror att de ska gå till marknaden senare, men inget är bestämt ännu.
Hon sa till mig att nycklarna låg på bordet bredvid de gamla fotografierna.
Vi har väntat på tåget i nästan en timme nu.
Det finns inte mycket att säga, förutom att det kunde ha gått bättre.
När du kommer hem, kom ihåg att stänga fönstren innan det börjar regna.
Han skulle hellre läsa en bok på kvällen än att titta på någonting alls.
De flesta människorna i byn har känt varandra i många år.
Kan du säga mig var närmaste station ligger, tack?
Det var en sådan dag då allting verkade hända på en gång.""",
    "da": """\
Det var meget koldt her til morgen, så vi blev inde og lavede te.
Jeg tror, de tager på markedet senere, men der er ikke besluttet noget endnu.
Hun fortalte mig, at nøglerne lå på bordet ved siden af de gamle billeder.
Vi har ventet på toget i næsten en time nu.
Der er ikke meget at sige om det, bortset fra at det kunne være gået bedre.
Når du kommer hjem, så husk at lukke vinduerne, før det begynder at regne.
Han ville hellere læse en bog om aftenen end at se noget som helst.
De fleste mennesker i landsbyen har kendt hinanden i mange år.
Kan du fortælle mig, hvor den nærmeste station ligger?
Det var sådan en dag, hvor alting syntes at ske på én gang.""",
    "no": """\
Det var veldig kaldt i morges, så vi ble inne og lagde te.
Jeg tror de skal dra til markedet senere, men ingenting er bestemt ennå.
Hun fortalte meg at nøklene lå på bordet ved siden av de gamle bildene.
Vi har ventet på toget i nesten en time nå.
Det er ikke mye å si om det, bortsett fra at det kunne gått bedre.
Når du kommer hjem, husk å lukke vinduene før det begynner å regne.
Han ville heller lese en bok om kvelden enn å se på noe som helst.
De fleste i bygda har kjent hverandre i mange år.
Kan du si meg hvor nærmeste stasjon ligger?
Det var en slik dag da alt så ut til å skje på en gang.""",
    "fi": """\
Tänä aamuna oli hyvin kylmä, joten jäimme sisälle juomaan teetä.
Luulen, että he menevät torille myöhemmin, mutta mitään ei ole päätetty.
Hän kertoi minulle, että avaimet olivat pöydällä vanhojen valokuvien vieressä.
Olemme odottaneet junaa jo melkein tunnin.
Siitä ei ole paljon sanottavaa, paitsi että se olisi voinut mennä paremmin.
Kun tulet kotiin, muista sulkea ikkunat ennen kuin alkaa sataa.
Hän lukisi mieluummin kirjaa illalla kuin katsoisi mitään.
Useimmat kylän ihmiset ovat tunteneet toisensa monta vuotta.
Voisitteko kertoa, missä lähin asema on?
Se oli yksi niistä päivistä, jolloin kaikki tuntui tapahtuvan yhtä aikaa.""",
    "is": """\
Það var mjög kalt í morgun, svo við vorum inni og bjuggum til te.
Ég held að þau fari á markaðinn seinna, en ekkert hefur verið ákveðið.
Hún sagði mér að lyklarnir væru á borðinu við hliðina á gömlu myndunum.
Við höfum beðið eftir lestinni í næstum klukkutíma.
Það er ekki mikið um það að segja, nema að það hefði getað farið betur.
Þegar þú kemur heim, mundu að loka gluggunum áður en það fer að rigna.
Hann myndi frekar lesa bók á kvöldin en að horfa á nokkuð.
Flestir í þorpinu hafa þekkst í mörg ár.
Getur þú sagt mér hvar næsta stöð er?
Þetta var einn af þessum dögum þegar allt virtist gerast í einu.""",
    "pl": """\
Dziś rano było bardzo zimno, więc zostaliśmy w domu i zrobiliśmy herbatę.
Myślę, że pójdą później na targ, ale nic jeszcze nie zostało ustalone.
Powiedziała mi, że klucze leżą na stole obok starych fotografii.
Czekamy na pociąg już prawie godzinę.
Niewiele można o tym powiedzieć, poza tym, że mogło pójść lepiej.
Kiedy wrócisz do domu, pamiętaj, żeby zamknąć okna, zanim zacznie padać.
Wolałby wieczorem czytać książkę, niż cokolwiek oglądać.
Większość ludzi we wsi zna się od wielu lat.
Czy może mi pan powiedzieć, gdzie jest najbliższa stacja?
To był jeden z tych dni, kiedy wszystko zdawało się dziać naraz.""",
    "cs": """\
Dnes ráno byla velká zima, takže jsme zůstali doma a uvařili si čaj.
Myslím, že později půjdou na trh, ale ještě nic není rozhodnuto.
Řekla mi, že klíče leží na stole vedle starých fotografií.
Na vlak čekáme už skoro hodinu.
Není o tom moc co říct, kromě toho, že to mohlo dopadnout lépe.
Až přijdeš domů, nezapomeň zavřít okna, než začne pršet.
Večer by si raději četl knihu, než aby se na cokoli díval.
Většina lidí ve vesnici se zná už mnoho let.
Můžete mi prosím říct, kde je nejbližší nádraží?
Byl to jeden z těch dnů, kdy se všechno zdálo dít najednou.""",
    "sk": """\
Dnes ráno bola veľká zima, takže sme zostali doma a uvarili sme si čaj.
Myslím, že neskôr pôjdu na trh, ale ešte nič nie je rozhodnuté.
Povedala mi, že kľúče ležia na stole vedľa starých fotografií.
Na vlak čakáme už takmer hodinu.
Nie je o tom veľa čo povedať, okrem toho, že to mohlo dopadnúť lepšie.
Keď prídeš domov, nezabudni zavrieť okná, skôr než začne pršať.
Večer by si radšej čítal knihu, než by sa na čokoľvek pozeral.
Väčšina ľudí v dedine sa pozná už mnoho rokov.
Môžete mi, prosím, povedať, kde je najbližšia stanica?
Bol to jeden z tých dní, keď sa všetko zdalo diať naraz.
Neviem, či prídeme načas, cesta je dlhá.
Povedz mi, čo si robil cez víkend, keď budeš mať chvíľu.""",
    "sl": """\
Danes zjutraj je bilo zelo mrzlo, zato smo ostali doma in skuhali čaj.
Mislim, da bodo pozneje šli na tržnico, a nič še ni odločeno.
Povedala mi je, da so ključi na mizi poleg starih fotografij.
Na vlak čakamo že skoraj eno uro.
O tem ni veliko povedati, razen da bi se lahko izteklo bolje.
Ko prideš domov, ne pozabi zapreti oken, preden začne deževati.
Zvečer bi raje bral knjigo, kot da bi karkoli gledal.
Večina ljudi v vasi se pozna že mnogo let.
Mi lahko poveste, kje je najbližja postaja, prosim?
Bil je eden tistih dni, ko se je zdelo, da se vse zgodi naenkrat.""",
    "hr": """\
Jutros je bilo vrlo hladno, pa smo ostali kod kuće i skuhali čaj.
Mislim da će kasnije ići na tržnicu, ali ništa još nije odlučeno.
Rekla mi je da su ključevi na stolu pokraj starih fotografija.
Vlak čekamo već gotovo sat vremena.
Nema se puno toga reći, osim da je moglo proći bolje.
Kad dođeš kući, sjeti se zatvoriti prozore prije nego počne kiša.
Navečer bi radije čitao knjigu nego išta gledao.
Većina ljudi u selu poznaje se već mnogo godina.
Možete li mi reći gdje je najbliži kolodvor, molim vas?
Bio je to jedan od onih dana kad se činilo da se sve događa odjednom.""",
    "sr": """\
Јутрос је било веома хладно, па смо остали код куће и скували чај.
Мислим да ће касније ићи на пијацу, али ништа још није одлучено.
Рекла ми је да су кључеви на столу поред старих фотографија.
Воз чекамо већ скоро сат времена.
Нема много тога да се каже, осим да је могло проћи боље.
Кад дођеш кући, сети се да затвориш прозоре пре него што почне киша.
Увече би радије читао књигу него било шта гледао.
Већина људи у селу познаје се већ много година.
Можете ли ми рећи где је најближа станица, молим вас?
Био је то један од оних дана када је изгледало да се све дешава одједном.""",
    "bg": """\
Тази сутрин беше много студено, затова останахме вкъщи и си направихме чай.
Мисля, че по-късно ще отидат на пазара, но още нищо не е решено.
Тя ми каза, че ключовете са на масата до старите снимки.
Чакаме влака вече почти час.
Няма много какво да се каже, освен че можеше да мине по-добре.
Когато се прибереш, не забравяй да затвориш прозорците, преди да завали.
Вечер той би предпочел да чете книга, отколкото да гледа каквото и да е.
Повечето хора в селото се познават от много години.
Можете ли да ми кажете къде е най-близката гара, моля?
Беше един от онези дни, в които всичко сякаш се случваше наведнъж.""",
    "mk": """\
Утринава беше многу студено, па останавме дома и си направивме чај.
Мислам дека подоцна ќе одат на пазар, но ништо уште не е одлучено.
Таа ми рече дека клучевите се на масата до старите фотографии.
Го чекаме возот веќе скоро еден час.
Нема многу што да се каже, освен дека можеше да помине подобро.
Кога ќе се вратиш дома, не заборавај да ги затвориш прозорците пред дождот.
Навечер тој повеќе би сакал да чита книга отколку да гледа било што.
Повеќето луѓе во селото се познаваат веќе многу години.
Може ли да ми кажете каде е најблиската станица, ве молам?
Беше еден од оние денови кога сè како да се случуваше одеднаш.
Тој секогаш доаѓа кај нас кога ќе има време.
Не знам дали ќе успееме да стигнеме навреме, патот е долг.
Ова е писмото што го чекавме цела недела.
Секое утро оди на работа во градот со автобус.
Што сакаш да правиме вечерва, ќе одиме ли некаде?
Тие се вратија доцна, но никој не беше уморен.""",
    "ru": """\
Сегодня утром было очень холодно, поэтому мы остались дома и заварили чай.
Я думаю, что они пойдут на рынок позже, но ничего ещё не решено.
Она сказала мне, что ключи лежат на столе рядом со старыми фотографиями.
Мы ждём поезд уже почти час.
Об этом нечего сказать, кроме того, что могло бы пройти лучше.
Когда придёшь домой, не забудь закрыть окна, пока не пошёл дождь.
Вечером он предпочёл бы читать книгу, чем что-либо смотреть.
Большинство людей в деревне знают друг друга уже много лет.
Не подскажете, где находится ближайшая станция?
Это был один из тех дней, когда всё, казалось, происходило сразу.
Большое спасибо за помощь, вы нам очень помогли.
Пожалуйста, скажите, когда вы будете дома.""",
    "uk": """\
Сьогодні вранці було дуже холодно, тому ми залишилися вдома й заварили чай.
Я думаю, що вони підуть на ринок пізніше, але ще нічого не вирішено.
Вона сказала мені, що ключі лежать на столі поруч зі старими фотографіями.
Ми чекаємо на потяг уже майже годину.
Про це нема чого багато казати, окрім того, що могло б пройти краще.
Коли прийдеш додому, не забудь зачинити вікна, поки не почався дощ.
Увечері він радше читав би книжку, ніж будь-що дивився.
Більшість людей у селі знають одне одного вже багато років.
Чи не підкажете, де найближча станція?
Це був один із тих днів, коли все, здавалося, відбувалося водночас.""",
    "be": """\
Сёння раніцай было вельмі холадна, таму мы засталіся дома і заварылі гарбату.
Я думаю, што яны пойдуць на рынак пазней, але яшчэ нічога не вырашана.
Яна сказала мне, што ключы ляжаць на стале побач са старымі фотаздымкамі.
Мы чакаем цягнік ужо амаль гадзіну.
Пра гэта няма чаго шмат казаць, акрамя таго, што магло б прайсці лепш.
Калі прыйдзеш дадому, не забудзься зачыніць вокны, пакуль не пайшоў дождж.
Увечары ён хутчэй чытаў бы кнігу, чым што-небудзь глядзеў.
Большасць людзей у вёсцы ведаюць адно аднаго ўжо шмат гадоў.
Ці не падкажаце, дзе найбліжэйшая станцыя?
Гэта быў адзін з тых дзён, калі ўсё, здавалася, адбывалася адразу.""",
    "ro": """\
Azi-dimineață a fost foarte frig, așa că am rămas acasă și am făcut ceai.
Cred că vor merge la piață mai târziu, dar nimic nu este încă hotărât.
Mi-a spus că cheile sunt pe masă, lângă fotografiile vechi.
Așteptăm trenul de aproape o oră.
Nu sunt multe de spus, în afară de faptul că putea să iasă mai bine.
Când ajungi acasă, nu uita să închizi ferestrele înainte să înceapă ploaia.
Seara ar prefera să citească o carte decât să se uite la orice altceva.
Majoritatea oamenilor din sat se cunosc de mulți ani.
Îmi puteți spune unde este cea mai apropiată gară, vă rog?
A fost una dintre zilele acelea în care totul părea să se întâmple deodată.""",
    "hu": """\
Ma reggel nagyon hideg volt, ezért otthon maradtunk és teát főztünk.
Azt hiszem, később elmennek a piacra, de még semmi sincs eldöntve.
Azt mondta nekem, hogy a kulcsok az asztalon vannak a régi fényképek mellett.
Már majdnem egy órája várjuk a vonatot.
Nincs sok mondanivaló róla, kivéve, hogy jobban is sikerülhetett volna.
Amikor hazaérsz, ne felejtsd el becsukni az ablakokat, mielőtt esni kezd.
Este inkább könyvet olvasna, mint hogy bármit is nézzen.
A faluban a legtöbb ember már sok éve ismeri egymást.
Meg tudná mondani, hol van a legközelebbi állomás?
Ez egyike volt azoknak a napoknak, amikor minden egyszerre történt.""",
    "et": """\
Täna hommikul oli väga külm, seega jäime koju ja tegime teed.
Ma arvan, et nad lähevad hiljem turule, aga midagi pole veel otsustatud.
Ta ütles mulle, et võtmed on laual vanade fotode kõrval.
Oleme rongi oodanud juba peaaegu tund aega.
Sellest pole palju rääkida, peale selle, et oleks võinud paremini minna.
Kui koju jõuad, ära unusta aknaid sulgeda, enne kui vihma sadama hakkab.
Ta loeks õhtul pigem raamatut, kui vaataks midagi.
Enamik küla inimesi on üksteist tundnud palju aastaid.
Kas te oskate öelda, kus on lähim jaam?
See oli üks neist päevadest, mil kõik näis korraga juhtuvat.
Ma ei tea, kas me jõuame õigeks ajaks kohale, tee on pikk.
Ta ütles, et saadab raha homme hommikul panga kaudu.""",
    "lv": """\
Šorīt bija ļoti auksts, tāpēc mēs palikām mājās un uzvārījām tēju.
Es domāju, ka viņi vēlāk ies uz tirgu, bet nekas vēl nav izlemts.
Viņa man teica, ka atslēgas ir uz galda blakus vecajām fotogrāfijām.
Mēs gaidām vilcienu jau gandrīz stundu.
Par to nav daudz ko teikt, izņemot to, ka varēja iet labāk.
Kad pārnāksi mājās, neaizmirsti aizvērt logus, pirms sāk līt.
Vakarā viņš labāk lasītu grāmatu, nekā kaut ko skatītos.
Lielākā daļa ciema ļaužu viens otru pazīst jau daudzus gadus.
Vai varat man pateikt, kur ir tuvākā stacija, lūdzu?
Tā bija viena no tām dienām, kad viss, šķiet, notika uzreiz.""",
    "lt": """\
Šįryt buvo labai šalta, todėl likome namuose ir išsivirėme arbatos.
Manau, kad jie vėliau eis į turgų, bet dar niekas nenuspręsta.
Ji man pasakė, kad raktai guli ant stalo šalia senų nuotraukų.
Traukinio laukiame jau beveik valandą.
Apie tai nedaug ką pasakysi, išskyrus tai, kad galėjo pavykti geriau.
Kai grįši namo, nepamiršk uždaryti langų, kol nepradėjo lyti.
Vakare jis mieliau skaitytų knygą, nei ką nors žiūrėtų.
Dauguma kaimo žmonių vienas kitą pažįsta jau daug metų.
Gal galite pasakyti, kur yra artimiausia stotis?
Tai buvo viena iš tų dienų, kai viskas, regis, vyko iš karto.""",
    "el": """\
Σήμερα το πρωί έκανε πολύ κρύο, οπότε μείναμε μέσα και φτιάξαμε τσάι.
Νομίζω ότι θα πάνε στην αγορά αργότερα, αλλά τίποτα δεν έχει αποφασιστεί.
Μου είπε ότι τα κλειδιά ήταν πάνω στο τραπέζι, δίπλα στις παλιές φωτογραφίες.
Περιμένουμε το τρένο σχεδόν μία ώρα τώρα.
Δεν υπάρχουν πολλά να πει κανείς, εκτός από το ότι θα μπορούσε να πάει καλύτερα.
Όταν γυρίσεις σπίτι, θυμήσου να κλείσεις τα παράθυρα πριν βρέξει.
Το βράδυ θα προτιμούσε να διαβάσει ένα βιβλίο παρά να δει οτιδήποτε.
Οι περισσότεροι άνθρωποι στο χωριό γνωρίζονται εδώ και πολλά χρόνια.
Μπορείτε να μου πείτε πού είναι ο πιο κοντινός σταθμός, παρακαλώ;
Ήταν μια από εκείνες τις μέρες που όλα έμοιαζαν να συμβαίνουν μαζί.""",
    "tr": """\
Bu sabah hava çok soğuktu, bu yüzden evde kalıp çay yaptık.
Sanırım daha sonra pazara gidecekler ama henüz hiçbir şey kararlaştırılmadı.
Bana anahtarların masanın üzerinde, eski fotoğrafların yanında olduğunu söyledi.
Neredeyse bir saattir treni bekliyoruz.
Bu konuda söylenecek çok şey yok, daha iyi gidebilirdi demek dışında.
Eve geldiğinde, yağmur başlamadan önce pencereleri kapatmayı unutma.
Akşamları bir şey izlemektense kitap okumayı tercih ederdi.
Köydeki insanların çoğu birbirini uzun yıllardır tanıyor.
En yakın istasyonun nerede olduğunu söyleyebilir misiniz lütfen?
Her şeyin aynı anda olduğu o günlerden biriydi.
Dün akşam bize gelen misafirler çok geç saatlere kadar kaldılar.
Bunu daha önce hiç duymamıştım, gerçekten ilginç bir hikâye.
Bunu sen mi yaptın, yoksa o mu yaptı bilmiyorum.
Sabah erkenden yola çıktık ama yolda çok bekledik.
Okuldan dönerken markete uğrayıp ekmek aldım.
Öğleden sonra bankaya gidip biraz para çektim.
Onu en son ne zaman gördün, hatırlıyor musun?""",
    "az": """\
Bu səhər hava çox soyuq idi, ona görə də evdə qalıb çay dəmlədik.
Düşünürəm ki, onlar sonra bazara gedəcəklər, amma hələ heç nə qərarlaşdırılmayıb.
O mənə dedi ki, açarlar masanın üstündə, köhnə şəkillərin yanındadır.
Biz artıq təxminən bir saatdır qatarı gözləyirik.
Bu barədə deməyə çox söz yoxdur, yalnız daha yaxşı ola bilərdi.
Evə gələndə yağış başlamazdan əvvəl pəncərələri bağlamağı unutma.
Axşamlar o, nəsə izləməkdənsə kitab oxumağı üstün tutardı.
Kənddəki insanların çoxu bir-birini uzun illərdir tanıyır.
Zəhmət olmasa, ən yaxın stansiyanın harada olduğunu deyə bilərsiniz?
Hər şeyin eyni vaxtda baş verdiyi günlərdən biri idi.""",
    "ca": """\
Aquest matí feia molt de fred, així que ens hem quedat a casa fent te.
Crec que aniran al mercat més tard, però encara no hi ha res decidit.
Em va dir que les claus eren sobre la taula, al costat de les fotos velles.
Fa gairebé una hora que esperem el tren.
No hi ha gaire cosa a dir, llevat que hauria pogut anar millor.
Quan arribis a casa, recorda tancar les finestres abans que plogui.
Ell preferiria llegir un llibre al vespre que no pas mirar res.
La majoria de la gent del poble es coneix des de fa molts anys.
Em podria dir on és l'estació més propera, si us plau?
Va ser un d'aquells dies en què tot semblava passar alhora.""",
    "gl": """\
Esta mañá ía moito frío, así que quedamos na casa tomando té.
Creo que irán ao mercado máis tarde, pero aínda non hai nada decidido.
Díxome que as chaves estaban enriba da mesa, a carón das fotos vellas.
Levamos case unha hora agardando polo tren.
Non hai moito que dicir, agás que podería ter saído mellor.
Cando chegues á casa, lembra pechar as fiestras antes de que chova.
El preferiría ler un libro pola noite antes que ver calquera cousa.
A maioría da xente da aldea coñécese desde hai moitos anos.
Pódeme dicir onde está a estación máis próxima, por favor?
Foi un deses días nos que todo parecía pasar ao mesmo tempo.""",
    "eu": """\
Gaur goizean oso hotz egiten zuen, beraz, etxean geratu ginen tea egiten.
Uste dut gero merkatura joango direla, baina oraindik ez dago ezer erabakita.
Esan zidan giltzak mahai gainean zeudela, argazki zaharren ondoan.
Ia ordubete daramagu trenaren zain.
Ez dago askorik esateko, hobeto atera zitekeela izan ezik.
Etxera iristen zarenean, gogoratu leihoak ixtea euria hasi baino lehen.
Berak nahiago luke gauez liburu bat irakurri ezer ikusi baino.
Herriko jende gehienak urte askoan ezagutzen du elkar.
Esan al didazu non dagoen geltokirik hurbilena, mesedez?
Dena batera gertatzen zela zirudien egun horietako bat izan zen.""",
    "cy": """\
Roedd hi'n oer iawn y bore yma, felly arhoson ni yn y tŷ a gwneud te.
Rwy'n credu y byddan nhw'n mynd i'r farchnad yn nes ymlaen, ond does dim byd wedi ei benderfynu eto.
Dywedodd hi wrtha i fod yr allweddi ar y bwrdd wrth ymyl yr hen luniau.
Rydyn ni wedi bod yn aros am y trên ers bron i awr.
Does dim llawer i'w ddweud, heblaw y gallai fod wedi mynd yn well.
Pan ddoi di adre, cofia gau'r ffenestri cyn iddi ddechrau bwrw glaw.
Byddai'n well ganddo ddarllen llyfr gyda'r nos na gwylio unrhyw beth.
Mae'r rhan fwyaf o bobl y pentref yn adnabod ei gilydd ers blynyddoedd.
Allwch chi ddweud wrtha i ble mae'r orsaf agosaf, os gwelwch yn dda?
Roedd hi'n un o'r dyddiau hynny pan oedd popeth fel petai'n digwydd ar unwaith.""",
    "ga": """\
Bhí sé an-fhuar ar maidin, mar sin d'fhanamar istigh agus rinneamar tae.
Sílim go rachaidh siad chuig an margadh níos déanaí, ach níl aon rud socraithe fós.
Dúirt sí liom go raibh na heochracha ar an mbord in aice leis na seanghrianghraif.
Táimid ag fanacht leis an traein le beagnach uair an chloig anois.
Níl mórán le rá faoi, ach amháin go bhféadfadh sé a bheith níos fearr.
Nuair a thiocfaidh tú abhaile, cuimhnigh na fuinneoga a dhúnadh sula dtosóidh an bháisteach.
B'fhearr leis leabhar a léamh tráthnóna ná aon rud a fheiceáil.
Tá aithne ag formhór na ndaoine sa sráidbhaile ar a chéile le blianta fada.
An féidir leat a rá liom cá bhfuil an stáisiún is gaire, le do thoil?
Ba cheann de na laethanta sin é nuair a tharla gach rud ag an am céanna.""",
    "sq": """\
Sot në mëngjes bënte shumë ftohtë, kështu që qëndruam brenda dhe bëmë çaj.
Mendoj se do të shkojnë në treg më vonë, por ende nuk është vendosur asgjë.
Ajo më tha se çelësat ishin mbi tavolinë, pranë fotografive të vjetra.
Po presim trenin prej gati një ore tashmë.
Nuk ka shumë për të thënë, përveçse mund të kishte shkuar më mirë.
Kur të kthehesh në shtëpi, mos harro të mbyllësh dritaret para se të bjerë shi.
Në mbrëmje ai do të preferonte të lexonte një libër sesa të shihte çfarëdo.
Shumica e njerëzve në fshat njihen me njëri-tjetrin prej shumë vitesh.
A mund të më thoni ku është stacioni më i afërt, ju lutem?
Ishte një nga ato ditë kur gjithçka dukej se ndodhte njëherësh.""",
    "af": """\
Dit was vanoggend baie koud, so ons het binne gebly en tee gemaak.
Ek dink hulle gaan later mark toe, maar niks is nog besluit nie.
Sy het my vertel dat die sleutels op die tafel lê, langs die ou foto's.
Ons wag nou al amper 'n uur vir die trein.
Daar is nie veel om oor te sê nie, behalwe dat dit beter kon gegaan het.
Wanneer jy by die huis kom, onthou om die vensters toe te maak voor dit reën.
Hy sou eerder saans 'n boek lees as om enigiets te kyk.
Die meeste mense in die dorpie ken mekaar al baie jare.
Kan jy my sê waar die naaste stasie is, asseblief?
Dit was een van daardie dae toe alles gelyktydig gebeur het.
Ons het gister die hele dag by die huis gebly omdat dit gereën het.
Sy het die hele middag in die tuin gewerk omdat die weer uiteindelik mooi was.""",
    "sw": """\
Asubuhi ya leo kulikuwa na baridi sana, kwa hiyo tulibaki ndani tukatengeneza chai.
Nadhani wataenda sokoni baadaye, lakini hakuna kilichoamuliwa bado.
Aliniambia kwamba funguo zilikuwa mezani kando ya picha za zamani.
Tumekuwa tukisubiri treni kwa karibu saa nzima sasa.
Hakuna mengi ya kusema, isipokuwa kwamba ingeweza kwenda vizuri zaidi.
Utakapofika nyumbani, kumbuka kufunga madirisha kabla mvua haijaanza.
Yeye angependelea kusoma kitabu jioni kuliko kutazama chochote.
Watu wengi kijijini wanafahamiana kwa miaka mingi.
Unaweza kuniambia kituo cha karibu kiko wapi, tafadhali?
Ilikuwa mojawapo ya siku zile ambazo kila kitu kilionekana kutokea mara moja.""",
    "id": """\
Pagi ini udaranya sangat dingin, jadi kami tetap di rumah dan membuat teh.
Saya kira mereka akan pergi ke pasar nanti, tetapi belum ada yang diputuskan.
Dia memberi tahu saya bahwa kunci-kunci itu ada di atas meja di samping foto-foto lama.
Kami sudah menunggu kereta hampir satu jam.
Tidak banyak yang bisa dikatakan, kecuali bahwa semuanya bisa berjalan lebih baik.
Kalau kamu sampai di rumah, jangan lupa menutup jendela sebelum hujan turun.
Dia lebih suka membaca buku pada malam hari daripada menonton apa pun.
Sebagian besar orang di desa sudah saling mengenal selama bertahun-tahun.
Bisakah Anda memberi tahu saya di mana stasiun terdekat?
Itu salah satu hari ketika segalanya tampak terjadi sekaligus.
Kami tidak bisa datang sekarang karena jalanan sedang macet sekali.
Apakah Anda sudah makan siang, atau mau menunggu sampai nanti?
Dia bilang akan mengirim uangnya besok pagi lewat bank.
Saya belum pernah melihat film itu, tetapi katanya bagus sekali.
Kalian harus berangkat sekarang supaya tidak terlambat.
Aku tidak tahu kenapa dia belum datang juga.
Rumah sakit itu terletak di sebelah kantor pos yang baru.""",
    "ms": """\
Pagi tadi cuaca sangat sejuk, jadi kami duduk di rumah dan membancuh teh.
Saya rasa mereka akan ke pasar kemudian, tetapi belum ada apa-apa yang diputuskan.
Dia memberitahu saya bahawa kunci itu terletak di atas meja di sebelah gambar-gambar lama.
Kami telah menunggu kereta api hampir sejam sekarang.
Tidak banyak yang boleh diperkatakan, kecuali ia boleh menjadi lebih baik.
Apabila kamu tiba di rumah, jangan lupa tutup tingkap sebelum hujan turun.
Dia lebih suka membaca buku pada waktu malam daripada menonton apa-apa.
Kebanyakan orang di kampung itu sudah saling mengenali sejak bertahun-tahun.
Bolehkah anda beritahu saya di mana stesen yang terdekat?
Ia merupakan salah satu hari apabila semuanya seolah-olah berlaku serentak.
Kami tidak boleh datang sekarang kerana jalan raya sesak sangat.
Adakah awak sudah makan tengah hari, atau mahu tunggu sehingga nanti?
Dia kata akan menghantar wang itu esok pagi melalui bank.
Saya belum pernah tengok filem itu, tetapi orang kata bagus sangat.
Awak boleh tolong saya sekejap? Saya nak hantar barang ini ke rumah kawan saya.
Mereka tidak mahu makan kerana sudah kenyang sangat.
Jangan lupa tutup pintu bila awak keluar nanti.
Doktor kata pesakit itu perlu berehat selama seminggu.
Dia belum sempat sampai ke rumah lagi.
Saya nampak mereka berdua di pasar semalam.
Kereta itu sangat cantik, harganya pun berpatutan.
Ayah bekerja lewat hari ini, jadi kami makan dahulu.
Kebiasaannya dia balik kampung setiap hujung minggu.""",
    "tl": """\
Napakalamig kaninang umaga, kaya nanatili kami sa bahay at nagtimpla ng tsaa.
Sa palagay ko pupunta sila sa palengke mamaya, pero wala pang napagpasyahan.
Sinabi niya sa akin na nasa mesa ang mga susi, katabi ng mga lumang litrato.
Halos isang oras na kaming naghihintay sa tren.
Wala nang masyadong masasabi, maliban sa maaari sanang mas maganda ang kinalabasan.
Pagdating mo sa bahay, tandaan mong isara ang mga bintana bago umulan.
Mas gusto niyang magbasa ng libro sa gabi kaysa manood ng kahit ano.
Karamihan sa mga tao sa nayon ay matagal nang magkakakilala.
Maaari mo bang sabihin sa akin kung nasaan ang pinakamalapit na istasyon?
Isa iyon sa mga araw na tila sabay-sabay na nangyari ang lahat.""",
    "vi": """\
Sáng nay trời rất lạnh, nên chúng tôi ở nhà và pha trà.
Tôi nghĩ lát nữa họ sẽ đi chợ, nhưng vẫn chưa có gì được quyết định.
Cô ấy nói với tôi rằng chìa khóa ở trên bàn, cạnh những bức ảnh cũ.
Chúng tôi đã đợi tàu gần một tiếng đồng hồ rồi.
Không có nhiều điều để nói, ngoại trừ việc lẽ ra mọi chuyện có thể tốt hơn.
Khi về đến nhà, nhớ đóng cửa sổ trước khi trời mưa nhé.
Buổi tối anh ấy thích đọc sách hơn là xem bất cứ thứ gì.
Hầu hết mọi người trong làng đã quen biết nhau nhiều năm.
Bạn có thể cho tôi biết nhà ga gần nhất ở đâu không?
Đó là một trong những ngày mà mọi thứ dường như xảy ra cùng một lúc.""",
    "th": """\
เช้านี้อากาศหนาวมาก เราจึงอยู่บ้านและชงชากัน
ฉันคิดว่าพวกเขาจะไปตลาดทีหลัง แต่ยังไม่มีอะไรตัดสินใจเลย
เธอบอกฉันว่ากุญแจอยู่บนโต๊ะ ข้างๆ รูปถ่ายเก่าๆ
เรารอรถไฟมาเกือบหนึ่งชั่วโมงแล้ว
ไม่มีอะไรจะพูดมากนัก นอกจากว่ามันน่าจะไปได้ดีกว่านี้
เมื่อกลับถึงบ้าน อย่าลืมปิดหน้าต่างก่อนฝนจะตก
ตอนเย็นเขาชอบอ่านหนังสือมากกว่าดูอะไรทั้งนั้น
คนส่วนใหญ่ในหมู่บ้านรู้จักกันมาหลายปีแล้ว
ช่วยบอกหน่อยได้ไหมว่าสถานีที่ใกล้ที่สุดอยู่ที่ไหน
มันเป็นวันหนึ่งที่ทุกอย่างดูเหมือนจะเกิดขึ้นพร้อมกัน""",
    "ko": """\
오늘 아침은 너무 추워서 우리는 집에 있으면서 차를 끓였다.
그들은 나중에 시장에 갈 것 같지만 아직 아무것도 정해지지 않았다.
그녀는 열쇠가 오래된 사진들 옆 탁자 위에 있다고 말해 주었다.
우리는 거의 한 시간째 기차를 기다리고 있다.
더 잘될 수도 있었다는 것 말고는 할 말이 별로 없다.
집에 도착하면 비가 오기 전에 창문을 꼭 닫아 주세요.
그는 저녁에 무언가를 보는 것보다 책을 읽는 편을 더 좋아한다.
마을 사람들 대부분은 서로 안 지 여러 해가 되었다.
가장 가까운 역이 어디인지 알려 주시겠어요?
모든 일이 한꺼번에 일어나는 것 같은 그런 날이었다.""",
    "ja": """\
今朝はとても寒かったので、私たちは家にいてお茶をいれました。
彼らは後で市場に行くと思いますが、まだ何も決まっていません。
彼女は鍵が古い写真の隣のテーブルの上にあると教えてくれました。
私たちはもう一時間近く電車を待っています。
もっとうまくいったはずだということ以外、あまり言うことはありません。
家に着いたら、雨が降る前に窓を閉めるのを忘れないでください。
彼は夜に何かを見るより本を読むほうが好きです。
村のほとんどの人は長年お互いを知っています。
一番近い駅がどこにあるか教えていただけますか。
すべてが一度に起こるように思えた、そんな一日でした。""",
    "zh": """\
今天早上很冷，所以我们待在家里泡了茶。
我想他们晚些时候会去市场，但还没有决定任何事情。
她告诉我钥匙在桌子上，就在那些旧照片旁边。
我们等火车已经快一个小时了。
没有什么可说的，只是本来可以更顺利一些。
你到家的时候，记得在下雨之前把窗户关上。
他晚上宁愿读书，也不想看任何东西。
村子里的大多数人已经认识很多年了。
请问最近的车站在哪里？
那是其中一个所有事情似乎同时发生的日子。
你知道他什么时候回来吗？我有一点事想问他。
这封信是昨天从银行寄来的，里面写了什么我还不知道。
我们明天要去看朋友，你要不要一起来？
他说他今天很忙，可能没有时间吃饭。""",
    "ar": """\
كان الجو باردًا جدًا هذا الصباح، لذلك بقينا في البيت وأعددنا الشاي.
أعتقد أنهم سيذهبون إلى السوق لاحقًا، لكن لم يتقرر أي شيء بعد.
قالت لي إن المفاتيح على الطاولة بجانب الصور القديمة.
نحن ننتظر القطار منذ ما يقارب الساعة.
ليس هناك الكثير ليقال، سوى أن الأمر كان يمكن أن يسير بشكل أفضل.
عندما تصل إلى البيت، لا تنسَ أن تغلق النوافذ قبل أن يبدأ المطر.
هو يفضل قراءة كتاب في المساء على مشاهدة أي شيء.
معظم الناس في القرية يعرفون بعضهم البعض منذ سنوات عديدة.
هل يمكنك أن تخبرني أين أقرب محطة من فضلك؟
كان يومًا من تلك الأيام التي بدا فيها أن كل شيء يحدث في وقت واحد.""",
    "he": """\
הבוקר היה קר מאוד, אז נשארנו בבית והכנו תה.
אני חושב שהם ילכו לשוק מאוחר יותר, אבל שום דבר עוד לא הוחלט.
היא אמרה לי שהמפתחות על השולחן, ליד התמונות הישנות.
אנחנו מחכים לרכבת כבר כמעט שעה.
אין הרבה מה לומר על זה, חוץ מזה שזה היה יכול ללכת טוב יותר.
כשתגיע הביתה, אל תשכח לסגור את החלונות לפני שיתחיל גשם.
הוא מעדיף לקרוא ספר בערב מאשר לצפות במשהו.
רוב האנשים בכפר מכירים זה את זה כבר שנים רבות.
אתה יכול להגיד לי איפה התחנה הקרובה ביותר, בבקשה?
זה היה אחד מהימים שבהם נדמה שהכול קורה בבת אחת.""",
    "fa": """\
امروز صبح هوا خیلی سرد بود، برای همین در خانه ماندیم و چای درست کردیم.
فکر می‌کنم بعداً به بازار بروند، اما هنوز هیچ چیز تصمیم‌گیری نشده است.
او به من گفت که کلیدها روی میز، کنار عکس‌های قدیمی است.
ما تقریباً یک ساعت است که منتظر قطار هستیم.
چیز زیادی برای گفتن نیست، جز اینکه می‌توانست بهتر پیش برود.
وقتی به خانه رسیدی، یادت باشد پیش از باران پنجره‌ها را ببندی.
او ترجیح می‌دهد شب‌ها کتاب بخواند تا اینکه چیزی تماشا کند.
بیشتر مردم روستا سال‌هاست که یکدیگر را می‌شناسند.
می‌توانید به من بگویید نزدیک‌ترین ایستگاه کجاست؟
یکی از آن روزهایی بود که انگار همه چیز همزمان اتفاق می‌افتاد.""",
    "ur": """\
آج صبح بہت سردی تھی، اس لیے ہم گھر میں رہے اور چائے بنائی۔
میرا خیال ہے کہ وہ بعد میں بازار جائیں گے، لیکن ابھی کچھ طے نہیں ہوا۔
اس نے مجھے بتایا کہ چابیاں میز پر پرانی تصویروں کے پاس ہیں۔
ہم تقریباً ایک گھنٹے سے ریل گاڑی کا انتظار کر رہے ہیں۔
اس کے بارے میں کہنے کو زیادہ کچھ نہیں، سوائے اس کے کہ بہتر ہو سکتا تھا۔
جب تم گھر پہنچو تو بارش شروع ہونے سے پہلے کھڑکیاں بند کرنا یاد رکھنا۔
وہ شام کو کچھ دیکھنے کے بجائے کتاب پڑھنا پسند کرتا ہے۔
گاؤں کے زیادہ تر لوگ ایک دوسرے کو کئی سالوں سے جانتے ہیں۔
کیا آپ مجھے بتا سکتے ہیں کہ قریب ترین اسٹیشن کہاں ہے؟
یہ ان دنوں میں سے ایک تھا جب سب کچھ ایک ساتھ ہوتا دکھائی دیتا تھا۔""",
    "hi": """\
आज सुबह बहुत ठंड थी, इसलिए हम घर पर ही रहे और चाय बनाई।
मुझे लगता है कि वे बाद में बाज़ार जाएँगे, लेकिन अभी कुछ तय नहीं हुआ है।
उसने मुझे बताया कि चाबियाँ मेज़ पर पुरानी तस्वीरों के पास रखी हैं।
हम लगभग एक घंटे से रेलगाड़ी का इंतज़ार कर रहे हैं।
इस बारे में कहने को ज़्यादा कुछ नहीं, सिवाय इसके कि यह बेहतर हो सकता था।
जब तुम घर पहुँचो, तो बारिश शुरू होने से पहले खिड़कियाँ बंद करना याद रखना।
वह शाम को कुछ देखने के बजाय किताब पढ़ना पसंद करता है।
गाँव के ज़्यादातर लोग एक-दूसरे को कई सालों से जानते हैं।
क्या आप मुझे बता सकते हैं कि सबसे नज़दीकी स्टेशन कहाँ है?
यह उन दिनों में से एक था जब सब कुछ एक साथ होता दिख रहा था।""",
    "mr": """\
आज सकाळी खूप थंडी होती, म्हणून आम्ही घरीच राहिलो आणि चहा केला.
मला वाटते की ते नंतर बाजारात जातील, पण अजून काहीही ठरलेले नाही.
तिने मला सांगितले की चाव्या टेबलावर जुन्या फोटोंच्या शेजारी आहेत.
आम्ही जवळजवळ तासभर गाडीची वाट पाहत आहोत.
याबद्दल सांगण्यासारखे फारसे काही नाही, फक्त हे अधिक चांगले होऊ शकले असते.
तू घरी पोहोचल्यावर पाऊस सुरू होण्यापूर्वी खिडक्या बंद करायला विसरू नकोस.
त्याला संध्याकाळी काहीही पाहण्यापेक्षा पुस्तक वाचायला आवडते.
गावातील बहुतेक लोक एकमेकांना अनेक वर्षांपासून ओळखतात.
सर्वात जवळचे स्थानक कुठे आहे ते मला सांगू शकाल का?
तो अशा दिवसांपैकी एक होता जेव्हा सगळे एकाच वेळी घडत असल्यासारखे वाटत होते.""",
    "bn": """\
আজ সকালে খুব ঠান্ডা ছিল, তাই আমরা বাড়িতে থেকে চা বানালাম।
আমার মনে হয় তারা পরে বাজারে যাবে, কিন্তু এখনো কিছু ঠিক হয়নি।
সে আমাকে বলল যে চাবিগুলো টেবিলের উপর পুরনো ছবিগুলোর পাশে আছে।
আমরা প্রায় এক ঘণ্টা ধরে ট্রেনের জন্য অপেক্ষা করছি।
এ নিয়ে বলার মতো বেশি কিছু নেই, শুধু এটা আরও ভালো হতে পারত।
বাড়ি পৌঁছে বৃষ্টি শুরু হওয়ার আগে জানালাগুলো বন্ধ করতে ভুলো না।
সে সন্ধ্যায় কিছু দেখার চেয়ে বই পড়তে বেশি পছন্দ করে।
গ্রামের বেশিরভাগ মানুষ বহু বছর ধরে একে অপরকে চেনে।
আপনি কি বলতে পারেন সবচেয়ে কাছের স্টেশন কোথায়?
এটা ছিল সেই দিনগুলোর একটা, যখন সবকিছু একসাথে ঘটছে বলে মনে হচ্ছিল।""",
    "ta": """\
இன்று காலை மிகவும் குளிராக இருந்தது, அதனால் நாங்கள் வீட்டிலேயே இருந்து தேநீர் தயாரித்தோம்.
அவர்கள் பிறகு சந்தைக்குச் செல்வார்கள் என்று நினைக்கிறேன், ஆனால் இன்னும் எதுவும் முடிவாகவில்லை.
சாவிகள் மேசையின் மேல் பழைய புகைப்படங்களுக்கு அருகில் இருப்பதாக அவள் என்னிடம் சொன்னாள்.
நாங்கள் கிட்டத்தட்ட ஒரு மணி நேரமாக ரயிலுக்காகக் காத்திருக்கிறோம்.
இன்னும் நன்றாக நடந்திருக்கலாம் என்பதைத் தவிர சொல்ல அதிகம் இல்லை.
நீ வீட்டுக்கு வந்ததும் மழை தொடங்கும் முன் ஜன்னல்களை மூட மறக்காதே.
அவன் மாலையில் எதையும் பார்ப்பதை விட புத்தகம் படிப்பதையே விரும்புகிறான்.
கிராமத்தில் உள்ள பெரும்பாலான மக்கள் பல ஆண்டுகளாக ஒருவரை ஒருவர் அறிவார்கள்.
அருகிலுள்ள நிலையம் எங்கே என்று சொல்ல முடியுமா?
எல்லாம் ஒரே நேரத்தில் நடப்பது போல் தோன்றிய நாட்களில் அதுவும் ஒன்று.""",
    "hy": """\
Այսօր առավոտյան շատ ցուրտ էր, ուստի մենք մնացինք տանը և թեյ պատրաստեցինք։
Կարծում եմ, որ նրանք ավելի ուշ կգնան շուկա, բայց դեռ ոչինչ որոշված չէ։
Նա ինձ ասաց, որ բանալիները սեղանի վրա են՝ հին լուսանկարների կողքին։
Մենք գնացքին սպասում ենք արդեն գրեթե մեկ ժամ։
Երբ տուն հասնես, չմոռանաս փակել պատուհանները՝ նախքան անձրևը սկսվի։
Գյուղի մարդկանց մեծ մասը միմյանց ճանաչում է շատ տարիներ։
Կարո՞ղ եք ասել, թե որտեղ է մոտակա կայարանը։""",
    "ka": """\
დღეს დილით ძალიან ციოდა, ამიტომ სახლში დავრჩით და ჩაი მოვამზადეთ.
ვფიქრობ, ისინი მოგვიანებით ბაზარში წავლენ, მაგრამ ჯერ არაფერია გადაწყვეტილი.
მან მითხრა, რომ გასაღებები მაგიდაზეა, ძველი ფოტოების გვერდით.
ჩვენ მატარებელს თითქმის ერთი საათია ველოდებით.
სახლში რომ მიხვალ, არ დაგავიწყდეს ფანჯრების დაკეტვა, სანამ წვიმა დაიწყება.
სოფლის ხალხის უმეტესობა ერთმანეთს მრავალი წელია იცნობს.
შეგიძლიათ მითხრათ, სად არის უახლოესი სადგური?""",
    "ne": """\
आज बिहान धेरै जाडो थियो, त्यसैले हामी घरमै बस्यौं र चिया बनायौं।
मलाई लाग्छ उनीहरू पछि बजार जानेछन्, तर अहिलेसम्म केही निर्णय भएको छैन।
उनले मलाई भनिन् कि साँचोहरू टेबलमाथि पुराना तस्बिरहरूको छेउमा छन्।
हामी करिब एक घण्टादेखि रेल कुरिरहेका छौं।
घर पुगेपछि पानी पर्नुअघि झ्यालहरू बन्द गर्न नबिर्सनू।
गाउँका धेरैजसो मानिसहरूले एकअर्कालाई धेरै वर्षदेखि चिन्छन्।
सबैभन्दा नजिकको स्टेसन कहाँ छ भन्न सक्नुहुन्छ?
ऊ सधैं बिहान सबेरै उठ्छ र खेतमा काम गर्न जान्छ।
तिमीले खाना खायौ कि खाएनौ?
हामी भोलि काठमाडौं जाँदैछौं, त्यहाँ मेरा साथीहरू बस्छन्।
यो किताब निकै राम्रो छ, मैले दुई पटक पढिसकें।
मेरा बुबा कार्यालयमा काम गर्नुहुन्छ र बेलुका ढिलो फर्कनुहुन्छ।
उनीहरू हरेक शनिबार मन्दिर जान्छन् र फूल चढाउँछन्।""",
    "gu": """\
આજે સવારે ખૂબ ઠંડી હતી, તેથી અમે ઘરમાં જ રહ્યા અને ચા બનાવી.
મને લાગે છે કે તેઓ પછી બજારમાં જશે, પણ હજી કંઈ નક્કી થયું નથી.
તેણે મને કહ્યું કે ચાવીઓ ટેબલ પર જૂના ફોટા પાસે છે.
અમે લગભગ એક કલાકથી ટ્રેનની રાહ જોઈ રહ્યા છીએ.
ઘરે પહોંચે ત્યારે વરસાદ શરૂ થાય તે પહેલાં બારીઓ બંધ કરવાનું ભૂલતો નહીં.
ગામના મોટા ભાગના લોકો એકબીજાને ઘણાં વર્ષોથી ઓળખે છે.
સૌથી નજીકનું સ્ટેશન ક્યાં છે તે કહી શકશો?""",
    "pa": """\
ਅੱਜ ਸਵੇਰੇ ਬਹੁਤ ਠੰਢ ਸੀ, ਇਸ ਲਈ ਅਸੀਂ ਘਰ ਹੀ ਰਹੇ ਅਤੇ ਚਾਹ ਬਣਾਈ।
ਮੈਨੂੰ ਲੱਗਦਾ ਹੈ ਕਿ ਉਹ ਬਾਅਦ ਵਿੱਚ ਬਾਜ਼ਾਰ ਜਾਣਗੇ, ਪਰ ਹਾਲੇ ਕੁਝ ਤੈਅ ਨਹੀਂ ਹੋਇਆ।
ਉਸਨੇ ਮੈਨੂੰ ਦੱਸਿਆ ਕਿ ਚਾਬੀਆਂ ਮੇਜ਼ ਉੱਤੇ ਪੁਰਾਣੀਆਂ ਤਸਵੀਰਾਂ ਕੋਲ ਹਨ।
ਅਸੀਂ ਲਗਭਗ ਇੱਕ ਘੰਟੇ ਤੋਂ ਗੱਡੀ ਦੀ ਉਡੀਕ ਕਰ ਰਹੇ ਹਾਂ।
ਘਰ ਪਹੁੰਚ ਕੇ ਮੀਂਹ ਪੈਣ ਤੋਂ ਪਹਿਲਾਂ ਖਿੜਕੀਆਂ ਬੰਦ ਕਰਨਾ ਨਾ ਭੁੱਲੀਂ।
ਪਿੰਡ ਦੇ ਬਹੁਤੇ ਲੋਕ ਇੱਕ ਦੂਜੇ ਨੂੰ ਕਈ ਸਾਲਾਂ ਤੋਂ ਜਾਣਦੇ ਹਨ।
ਕੀ ਤੁਸੀਂ ਦੱਸ ਸਕਦੇ ਹੋ ਕਿ ਸਭ ਤੋਂ ਨੇੜਲਾ ਸਟੇਸ਼ਨ ਕਿੱਥੇ ਹੈ?""",
    "kn": """\
ಇಂದು ಬೆಳಿಗ್ಗೆ ತುಂಬಾ ಚಳಿ ಇತ್ತು, ಹಾಗಾಗಿ ನಾವು ಮನೆಯಲ್ಲಿಯೇ ಇದ್ದು ಚಹಾ ಮಾಡಿದೆವು.
ಅವರು ನಂತರ ಮಾರುಕಟ್ಟೆಗೆ ಹೋಗುತ್ತಾರೆ ಎಂದು ನನಗೆ ಅನಿಸುತ್ತದೆ, ಆದರೆ ಇನ್ನೂ ಏನೂ ನಿರ್ಧಾರವಾಗಿಲ್ಲ.
ಬೀಗದ ಕೈಗಳು ಮೇಜಿನ ಮೇಲೆ ಹಳೆಯ ಫೋಟೋಗಳ ಪಕ್ಕ ಇವೆ ಎಂದು ಅವಳು ನನಗೆ ಹೇಳಿದಳು.
ನಾವು ಸುಮಾರು ಒಂದು ಗಂಟೆಯಿಂದ ರೈಲಿಗಾಗಿ ಕಾಯುತ್ತಿದ್ದೇವೆ.
ಮನೆಗೆ ತಲುಪಿದ ಮೇಲೆ ಮಳೆ ಶುರುವಾಗುವ ಮೊದಲು ಕಿಟಕಿಗಳನ್ನು ಮುಚ್ಚಲು ಮರೆಯಬೇಡ.
ಹಳ್ಳಿಯ ಹೆಚ್ಚಿನ ಜನರು ಒಬ್ಬರನ್ನೊಬ್ಬರು ಹಲವು ವರ್ಷಗಳಿಂದ ಬಲ್ಲರು.
ಹತ್ತಿರದ ನಿಲ್ದಾಣ ಎಲ್ಲಿದೆ ಎಂದು ಹೇಳಬಹುದೇ?""",
    "ml": """\
ഇന്ന് രാവിലെ നല്ല തണുപ്പായിരുന്നു, അതിനാൽ ഞങ്ങൾ വീട്ടിൽ തന്നെ ഇരുന്ന് ചായ ഉണ്ടാക്കി.
അവർ പിന്നീട് ചന്തയിൽ പോകുമെന്ന് ഞാൻ കരുതുന്നു, പക്ഷേ ഇതുവരെ ഒന്നും തീരുമാനിച്ചിട്ടില്ല.
താക്കോലുകൾ മേശപ്പുറത്ത് പഴയ ഫോട്ടോകളുടെ അടുത്താണെന്ന് അവൾ എന്നോട് പറഞ്ഞു.
ഞങ്ങൾ ഏകദേശം ഒരു മണിക്കൂറായി തീവണ്ടിക്കായി കാത്തിരിക്കുന്നു.
വീട്ടിൽ എത്തിയാൽ മഴ തുടങ്ങും മുമ്പ് ജനലുകൾ അടയ്ക്കാൻ മറക്കരുത്.
ഗ്രാമത്തിലെ മിക്ക ആളുകളും പരസ്പരം വർഷങ്ങളായി അറിയുന്നവരാണ്.
ഏറ്റവും അടുത്തുള്ള സ്റ്റേഷൻ എവിടെയാണെന്ന് പറയാമോ?""",
    "si": """\
අද උදේ හුඟක් සීතල නිසා අපි ගෙදරම ඉඳලා තේ හැදුවා.
ඔවුන් පසුව වෙළඳපොළට යයි කියලා මම හිතනවා, නමුත් තවම කිසිවක් තීරණය වී නැහැ.
යතුරු මේසය උඩ පරණ ඡායාරූප ළඟ තියෙනවා කියලා ඇය මට කිව්වා.
අපි පැයක් විතර දුම්රියට බලාගෙන ඉන්නවා.
ගෙදර ගියාම වැස්ස පටන් ගන්න කලින් ජනේල වහන්න අමතක කරන්න එපා.
ගමේ බොහෝ අය අවුරුදු ගණනාවක් තිස්සේ එකිනෙකා හඳුනනවා.
ළඟම දුම්රිය ස්ථානය කොහෙද කියලා කියන්න පුළුවන්ද?""",
    "la": """\
Hodie mane frigidissimum erat, itaque domi mansimus et aquam calidam paravimus.
Puto eos postea ad forum ituros esse, sed nihil adhuc constitutum est.
Mihi dixit claves in mensa iuxta imagines veteres esse.
Iam fere horam trenum exspectamus, id est vehiculum ferriviarium.
Cum domum perveneris, noli oblivisci fenestras claudere antequam pluere incipiat.
Plerique homines in vico inter se multos annos noverunt.
Potesne mihi dicere ubi statio proxima sit?
Erat unus ex illis diebus quibus omnia simul accidere videbantur.
Gallia est omnis divisa in partes tres, quarum unam incolunt Belgae.
Magister discipulis multas fabulas de rebus antiquis narrabat.
Non scholae sed vitae discimus, ut maiores nostri dicebant.
Tempus fugit neque umquam revertitur, itaque carpe diem.""",
    "kk": """\
Бүгін таңертең өте суық болды, сондықтан біз үйде қалып, шай дайындадық.
Менің ойымша, олар кейін базарға барады, бірақ әлі ештеңе шешілген жоқ.
Ол маған кілттер үстелдің үстінде, ескі суреттердің қасында жатыр деді.
Біз пойызды бір сағатқа жуық күтіп тұрмыз.
Үйге жеткенде, жаңбыр басталмай тұрып терезелерді жабуды ұмытпа.
Ауылдағы адамдардың көбі бірін-бірі көп жылдан бері біледі.
Ең жақын бекет қайда екенін айта аласыз ба?""",
    "uz": """\
Bugun ertalab juda sovuq edi, shuning uchun uyda qolib choy damladik.
Menimcha, ular keyinroq bozorga borishadi, lekin hali hech narsa hal qilinmagan.
U menga kalitlar stol ustida, eski suratlar yonida ekanini aytdi.
Biz poyezdni deyarli bir soatdan beri kutyapmiz.
Uyga yetib borganingda, yomg'ir boshlanishidan oldin derazalarni yopishni unutma.
Qishloqdagi odamlarning ko'pchiligi bir-birini ko'p yillardan beri taniydi.
Eng yaqin bekat qayerda ekanini ayta olasizmi?
Bolalar maktabdan qaytib, hovlida o'ynashni yaxshi ko'rishadi.
Ertaga ob-havo yaxshi bo'lsa, biz tog'larga boramiz.
U o'zbek tilida juda chiroyli she'rlar yozadi.
Do'konlar bugun soat to'qqizgacha ishlaydi.
Opam shifoxonada hamshira bo'lib ishlaydi.
U har kuni ishga erta ketadi va kechqurun kech qaytadi.""",
    "te": """\
ఈ రోజు ఉదయం చాలా చలిగా ఉంది, అందుకే మేము ఇంట్లోనే ఉండి టీ చేసుకున్నాం.
వాళ్ళు తర్వాత మార్కెట్‌కు వెళ్తారని అనుకుంటున్నాను, కానీ ఇంకా ఏమీ నిర్ణయం కాలేదు.
తాళాలు పాత ఫోటోల పక్కన బల్ల మీద ఉన్నాయని ఆమె నాకు చెప్పింది.
మేము దాదాపు గంట నుంచి రైలు కోసం ఎదురు చూస్తున్నాం.
ఇంకా బాగా జరిగి ఉండేదన్న విషయం తప్ప చెప్పడానికి పెద్దగా ఏమీ లేదు.
నువ్వు ఇంటికి చేరగానే వర్షం మొదలయ్యే ముందు కిటికీలు మూయడం మర్చిపోకు.
అతను సాయంత్రం ఏదైనా చూడటం కంటే పుస్తకం చదవడమే ఇష్టపడతాడు.
ఊరిలోని చాలా మంది ఒకరినొకరు ఎన్నో ఏళ్లుగా తెలుసు.
దగ్గరలో ఉన్న స్టేషన్ ఎక్కడ ఉందో చెప్పగలరా?
అన్నీ ఒకేసారి జరుగుతున్నట్టు అనిపించిన రోజుల్లో అది ఒకటి.""",
}
